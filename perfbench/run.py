"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (``setup_s``: from the start of this
module to the first timed call) draws the cell's inputs on the card from
the seed, builds the system and warms it at the cell's shapes. The window
then runs the mix's closed loop for ``--seconds`` (``--trace 1``: for the
mix's ``trace_seconds`` under ``torch.profiler``). After it the memory
peak is read, the program's state is freed, and the plain reference checks
what the window produced. The last lines on standard error give each
compared number beside its limit; the last line on standard output is the
result: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
(``--trace 0``) or per-layer (``--trace 1``) metrics, ``device``, with
``--trace 1`` the ``breakdown``, and last the ``checks``.

Exits 2 without a result where CUDA is missing or has fewer cards than
the cell asks for, and 3 where JAX, jaxlib, flax or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": ".perfbench_cache/triton",
              "TORCH_EXTENSIONS_DIR": ".perfbench_cache/torch_extensions"}
BANNED = ("jax", "jaxlib", "flax", "recommendit_tpu")
WARM_TRACED = 2        # untimed calls under the profiler before the traced window


def set_env(root: Path) -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(root / rel)


def banned_modules():
    """Top-level names of loaded modules that must not be loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Set-up, window and check of one run; → the result line's fields."""
    import torch

    from perfbench import judge
    from perfbench.spec import Ctx, read_metrics
    from perfbench.traffic import make_batches
    from perfbench.window import closed_loop

    system = importlib.import_module(f"perfbench.systems.{cell.config['system']}")
    sess = system.Session(cell, seed, device)
    batches = make_batches(cell.traffic, seed, sess.sizes, sess.device)
    start = sess.warm(batches)
    sess.sync()
    setup_s = time.perf_counter() - t0

    def loop(secs, ranges, first):
        return closed_loop(sess.call, batches, sess.rows, secs, finish=sess.finish,
                           drain=sess.drain, on_result=sess.on_result, ranges=ranges,
                           start=first)

    summary = None
    if trace:
        from perfbench.trace import capture, summarize

        with capture(sess.sync) as tr:
            sess.layer_ranges(True)
            for k in range(WARM_TRACED):
                out = sess.call(batches[(start + k) % len(batches)])
                if sess.finish is not None:
                    sess.finish(out)
            sess.sync()
            win = loop(min(seconds, float(cell.traffic["trace_seconds"])), True,
                       start + WARM_TRACED)
            sess.layer_ranges(False)
        summary = summarize(tr["events"])
        busy_s, window_s = sess.busy(summary)
        del tr
    else:
        win = loop(seconds, False, start)
    peak = sess.memory_peak_bytes()
    facts = sess.facts()
    sess.release()
    numbers = sess.numbers(batches)
    chk = judge.checks(numbers, sess.limits)
    whole = summary.count(sess.marker) if summary is not None else None
    ctx = Ctx(cell=cell, setup_s=setup_s, window=win, memory_peak_bytes=peak, facts=facts,
              trace=summary, whole=whole)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    dev = torch.device(device)
    result = {
        "correct": judge.passed(chk),
        "attempted": len(win.calls),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(sess.device)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if summary is not None:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = summary.breakdown
        print(f"perfbench: the trace holds {whole} of {summary.n_calls} calls by "
              f"{sess.marker!r} launches; lost {summary.n_calls - whole}", file=sys.stderr)
    result["checks"] = chk
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    set_env(root)

    import torch

    from perfbench.spec import load_cell

    cell = load_cell(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{n} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = banned_modules()
    if found:
        print(f"perfbench: loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"perfbench: correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
