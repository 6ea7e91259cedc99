"""The control of the DLRM-DCNv2 cell's check, and the fault it must catch.

    python3 -m perfbench.ctr_control --workload <cell> --seeds <n> [<n> ...]
        [--what control dedup] [--device cuda|cpu]

For each seed, the plain reference is put in the program's place and
judged against the reference by the cell's own comparison
(``perfbench.systems.ctr_train.numbers``), on the cell's inputs and sizes:
``control`` computes every product in TF32, one precision below the
configuration's float32; ``dedup`` leaves out the table update's
deduplication, adding each slot's squared gradient to the accumulator
(``acc += Σ g²``) where exact Adagrad adds the square of the row's summed
gradient (``(Σ g)²``). Prints one JSON line per seed and kind with the
compared numbers. The benchmark's runs never run this; the configuration's
limits are set from its readings and from the runs' own. (``perfbench/
control.py`` runs the other cells' controls; it knows no ``ctr_train``
system.)
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from perfbench import ctr_inputs, judge
from perfbench.reference import dlrm_dcnv2_train as ref
from perfbench.spec import load_cell
from perfbench.systems import ctr_train

KINDS = ("control", "dedup")


class NoDedup(ref.Reference):
    """The fault: each slot's gradient squared into the accumulator."""

    def table_update(self, uniq, g, slots):
        inv, slot_grads = slots
        a = self.acc["embed"][uniq].index_add_(0, inv, slot_grads * slot_grads)
        self.acc["embed"][uniq] = a
        self.p["embed"][uniq] -= self.lr * (g / (torch.sqrt(a) + self.eps))


def control_numbers(cell, seed: int, device, what: str) -> dict:
    if what not in KINDS:
        raise ValueError(f"the DLRM cell has no {what!r}")
    cfg = cell.config
    pool = ctr_inputs.batches(cfg, cell.traffic, seed, device)
    rows = ctr_inputs.touched_rows(pool, ctr_train.WARM_STEPS)
    if what == "control":
        r = ctr_train.reference(cfg, seed, device, cfg["control"]["matmul"])
    else:
        r = ctr_train.reference(cfg, seed, device, cls=NoDedup)
    got = ref.run(r, pool, rows, ctr_train.WARM_STEPS)
    del r
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    r = ctr_train.reference(cfg, seed, device)
    w0 = ref.rows_at(r.p["embed"], rows)
    want = ref.run(r, pool, rows, ctr_train.WARM_STEPS)
    del r
    return ctr_train.numbers(got, want, w0, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The control of the DLRM cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=list(KINDS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, Path.cwd())
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench.ctr_control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for what in args.what:
            nums = control_numbers(cell, seed, args.device, what)
            chk = judge.checks(nums, cell.config["checks"])
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "correct": judge.passed(chk), "numbers": nums}), flush=True)
            if torch.device(args.device).type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
