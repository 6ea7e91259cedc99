"""How long the micro-batcher must wait for live traffic to fill the 1,024
bucket: ``chip_smoke.http_phase`` at several waits. A measurement tool,
outside the package: nothing imports it.

    python3 tools/http_wait_sweep.py [--waits 20,100,300] [--seed 0]

On the card, from the repo root: builds the two window kernels, writes the
serve artifacts of ``chip_smoke.py`` (1M items; under
``recommendit_tpu_torch/build/http_wait_sweep/``), loads the bf16 and int8
pipelines, then runs the HTTP phase once per wait (levels of 1, 64 and 512
closed-loop clients, then 512 over int8). A wait at which no live dispatch
reaches the 1,024 bucket fails the phase; the sweep prints that and goes
on. Each level's QPS, latency and batch sizes are printed as the phase
prints them, and one summary line per wait.
"""
import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waits", default="20,100,300", help="waits in ms")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("http_wait_sweep: no CUDA device", file=sys.stderr)
        return 2
    from recommendit_tpu_torch.ops import _build

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.load_library, ["window_mips", "window_mips_i8"]))
    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    paths, data = chip_smoke.make_artifacts(
        ROOT / "recommendit_tpu_torch" / "build" / "http_wait_sweep", args.seed,
        device)
    pipes = [chip_smoke.load_pipeline(paths, data, device, dtype)
             for dtype in ("bfloat16", "int8")]
    for i, wait in enumerate(float(w) for w in args.waits.split(",")):
        t0 = time.perf_counter()
        try:
            # a new seed each time: another user takes the feature update
            out = chip_smoke.http_phase(*pipes, device, wait_ms=wait,
                                        seed=args.seed + i)
            summary = {label: {k: v for k, v in rec.items() if k != "levels"}
                       for label, rec in out.items()}
            row = {"wait_ms": wait, "ok": True, "summary": summary}
        except AssertionError as exc:
            row = {"wait_ms": wait, "ok": False, "error": str(exc)[:600]}
        row.update(seconds=time.perf_counter() - t0, card=card)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
