"""How many kernel records ``torch.profiler`` loses on the card: runs of
``--steps`` steps, each the two BPR kernel wrappers (forward and backward,
B=1024, D=64) and 60 small elementwise launches, under
``profile(activities=[CUDA])`` as ``chip_smoke.py``'s pipeline phase
profiles a tower training, and each BPR kernel's recorded count against
its launches. A measurement tool, outside the package: nothing imports it.

    python3 tools/profiler_record_loss.py [--runs 8] [--steps 800]

Prints one JSON line per run (each kernel's recorded count) and a summary
line (runs short of the launches, the largest loss).
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
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=800)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_record_loss: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from recommendit_tpu_torch.ops import bpr

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.randn(1024, 64, device=device, generator=gen)
    v = torch.randn(1024, 64, device=device, generator=gen)
    g = torch.ones((), device=device)
    x = torch.randn(4096, device=device, generator=gen)
    losses = []
    for run in range(args.runs):
        launches = dict(bpr.LAUNCHES)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                bpr.bpr_forward(u, v)
                bpr.bpr_backward(u, v, g)
                for _ in range(60):
                    x = x * 1.0001
            torch.cuda.synchronize()
        launched = {k: bpr.LAUNCHES[k] - launches[k] for k in launches}
        counts = {}
        for key, _, count in chip_smoke.device_events(prof):
            name = chip_smoke._short_kernel_name(key)
            if name.startswith("bpr_"):
                counts[name] = counts.get(name, 0) + count
        losses.append(args.steps - min(counts.values()))
        print(json.dumps({"run": run, "launched": launched, "recorded": counts}),
              flush=True)
    print(json.dumps({"runs": args.runs, "steps": args.steps,
                      "runs_short": sum(1 for n in losses if n),
                      "largest_loss": max(losses),
                      "largest_loss_share": max(losses) / args.steps,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
