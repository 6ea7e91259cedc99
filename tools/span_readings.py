"""The program's spans in a benchmark cell's traced window, beside the
benchmark's own readings of the same run.

    python3 tools/span_readings.py --workload <cell> --seed <n> [--seconds 3]
        [--root DIR] [--device cuda|cpu] [--out FILE]

Runs the cell once as ``python3 -m perfbench.run --trace 1`` runs it
(``perfbench.run.run_cell``, from the root of a checkout, or ``--root``)
and reads its Chrome trace twice: by ``perfbench.trace.summarize``, for the
benchmark's per-layer metrics, and by ``perfbench.spans.summarize_spans``,
for the program's spans. Prints one JSON line: the card's name and power
limit; ``correct`` and the per-layer ``metrics`` of the run; ``spans``: for
each span the program opened, its device ms, kernels and device idle ms a
call, over the calls whose kernels the trace holds (the benchmark's
``trace_marker`` count, as its per-call readers divide); ``host``: the
traced window's ms a call and, in a serve cell, its mean host ms from the
call to its return (``serve.host_ms``); and ``agree``: the serve call's
span against the benchmark's ``perfbench.retrieve`` range and the rest of
its calls, the share of the call in its leaf spans, and the optimizer's
span against the benchmark's ``perfbench.optim`` range and its share in
``train.clip`` and ``train.adamw``. On a program without the spans,
``spans`` and ``agree`` are empty; where the trace holds no whole call (no
card), ``spans`` gives only how often each span was opened. A measurement
tool, outside the package and the benchmark: it keeps the trace's events
by wrapping ``perfbench.trace.summarize`` for the run.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SERVE_LEAVES = ("serve.tower", "retrieve.score", "retrieve.prune", "retrieve.select",
                "rank.features", "rank.scorer", "rank.select")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def per_call(spans, whole: int) -> dict:
    return {n: {"device_ms": 1e3 * spans.span_s(n) / whole,
                "kernels": spans.span_kernels(n) / whole,
                "idle_ms": 1e3 * spans.idle_in_s(n) / whole,
                "opened": spans.opened[n]}
            for n in sorted(spans.opened)}


def agreement(summary, rows: dict, whole: int) -> dict:
    out = {}
    ms = {n: r["device_ms"] for n, r in rows.items()}
    if "serve.batch" in ms:
        retrieve = 1e3 * summary.layer_s("retrieve") / whole
        rest = 1e3 * summary.layer_s(None) / whole
        out["serve_batch_over_retrieve_plus_rank"] = ms["serve.batch"] / (retrieve + rest)
        out["serve_retrieve_over_range"] = ms.get("serve.retrieve", 0.0) / retrieve
        out["leaf_share"] = sum(ms.get(n, 0.0) for n in SERVE_LEAVES) / ms["serve.batch"]
    if "train.optim" in ms:
        optim = 1e3 * summary.layer_s("optim") / whole
        out["train_optim_over_range"] = ms["train.optim"] / optim
        out["clip_adamw_share"] = (ms.get("train.clip", 0.0)
                                   + ms.get("train.adamw", 0.0)) / ms["train.optim"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--root", default=".")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    from perfbench import run as bench_run
    from perfbench import trace
    from perfbench.spans import summarize_spans
    from perfbench.spec import load_cell

    bench_run.set_env(root)
    cell = load_cell(args.workload, root)
    kept = {}
    summarize = trace.summarize

    def keep(events, *a, **kw):
        s = summarize(events, *a, **kw)
        kept.setdefault("events", events)
        kept.setdefault("summary", s)
        return s

    trace.summarize = keep
    result = bench_run.run_cell(cell, args.seed, args.seconds, True, args.device, T_START)
    summary = kept["summary"]
    whole = summary.count(cell.config["trace_marker"])
    spans = summarize_spans(kept.pop("events"))
    rows = per_call(spans, whole) if whole else {n: {"opened": c}
                                                 for n, c in sorted(spans.opened.items())}
    line = {"workload": args.workload, "seed": args.seed, "card": card(),
            "correct": result["correct"], "whole": whole, "n_calls": summary.n_calls,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "host": {"window_ms_per_call": 1e3 * summary.window_s / max(1, summary.n_calls)},
            "spans": rows, "agree": agreement(summary, rows, whole) if whole else {}}
    if "serve.host_ms" in line["metrics"]:
        line["host"]["serve_host_ms"] = line["metrics"]["serve.host_ms"]
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
