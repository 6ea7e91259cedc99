"""Build, check and time the port's MIPS kernels at one shape — the
counterpart of ``scripts/pallas_probe.py``.

One (variant, shape) per call; prints one JSON line with the JAX probe's
keys (``platform`` is ``"gpu"`` on the card, and ``kind`` names it):

    python -m recommendit_tpu_torch.scripts.kernel_probe \\
        --variant window_im --n 131072 --d 128 --q 256 --k 500 \\
        --block 2048 --window 64

Variants: ``window`` (``ops.mips_window.mips_topk_window``, the
queries-major window kernel), ``window_im`` (``mips_topk_window_im``, the
items-major one), ``window_im_int8`` (``mips_topk_window_im_int8`` over the
corpus quantised with seed 0) and ``fold`` (``ops.mips_fold.
mips_topk_fused``, ``--window`` being its reduction R). ``--device cpu``
runs the plain twins (a rehearsal without a card); the default is the card,
and without one the probe fails.

The check is the JAX probe's: on the first 4 queries every returned value
must be the true score of its row (f32 scores of the f32 queries; for int8
the int8 scores the kernel ranks) within 1e-2 (1e-3 at ``--precision
highest``, 1e-2 more over a bf16 corpus), and the top-1 must be the exact
argmax. The time is the mean of ``--iters`` calls after one warm-up, by CUDA
events on the card (host clock on the CPU).

Exit codes: 0 ok, 2 wrong result, anything else a build or launch failure.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

VARIANTS = ("window", "window_im", "window_im_int8", "fold")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", required=True, choices=VARIANTS)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--block", type=int, default=2048)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--precision", default="default",
                    choices=["default", "highest"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="corpus storage dtype (bf16 halves the corpus bytes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    return ap.parse_args(argv)


def _timed(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def probe(argv: Optional[List[str]] = None) -> Tuple[int, dict]:
    """(exit code, the JSON record) of one probe."""
    from recommendit_tpu_torch.ops import mips_fold as mf
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.quantize import quantize_int8
    from recommendit_tpu_torch.ops.topk import full_f32_matmul, quantize_queries
    from recommendit_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    q0 = torch.as_tensor(rng.normal(size=(args.q, args.d)).astype(np.float32),
                         device=device)
    items = torch.as_tensor(rng.normal(size=(args.n, args.d)).astype(np.float32),
                            device=device)
    items = (items / items.norm(dim=1, keepdim=True)).to(getattr(torch, args.dtype))

    scales = None
    if args.variant == "fold":
        def fn():
            return mf.mips_topk_fused(q0, items, args.k, args.block, args.window)
    elif args.variant == "window":
        def fn():
            return mw.mips_topk_window(q0, items, args.k, args.block,
                                       args.window, args.precision)
    elif args.variant == "window_im_int8":
        items, scales = quantize_int8(items.float(), 0)

        def fn():
            return mw.mips_topk_window_im_int8(q0, items, scales, args.k,
                                               args.block, args.window)
    else:
        def fn():
            return mw.mips_topk_window_im(q0, items, args.k, args.block,
                                          args.window, args.precision)

    t0 = time.perf_counter()
    v, i = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    qs = q0[:4]
    with full_f32_matmul():
        if scales is not None:
            q8, qsc = quantize_queries(qs)
            scores_ref = (q8.float() @ items.float().T * qsc[:, None]
                          * scales[None, :])
        else:
            scores_ref = qs @ items.float().T
    got = torch.gather(scores_ref, 1, i[:4])
    atol = 1e-3 if args.precision == "highest" else 1e-2
    if args.dtype == "bfloat16":
        atol += 1e-2
    err = float((got - v[:4]).abs().max())
    ok_vals = err < atol
    ok_top1 = bool((i[:4, 0] == scores_ref.argmax(dim=1)).all())
    order = torch.topk(scores_ref, args.k, dim=1).indices
    recall = float(np.mean([
        len(set(i[r].tolist()) & set(order[r].tolist())) / args.k
        for r in range(qs.shape[0])]))

    dt_ms = _timed(fn, args.iters, device)
    rec = {
        "variant": args.variant,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "n": args.n, "d": args.d, "q": args.q, "k": args.k,
        "block": args.block, "window": args.window,
        "precision": args.precision, "dtype": args.dtype,
        "compile_s": compile_s,
        "batch_ms": dt_ms,
        "qps": args.q / (dt_ms / 1000),
        "ok_vals": ok_vals, "max_val_err": err,
        "ok_top1": ok_top1,
        "recall_at_k": recall,
    }
    return (0 if ok_vals and ok_top1 else 2), rec


def main(argv: Optional[List[str]] = None) -> int:
    code, rec = probe(argv)
    print(json.dumps(rec), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
