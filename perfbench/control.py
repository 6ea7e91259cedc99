"""The control of a cell's check, and the faults it must catch.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...] [--what control half]

For each seed, the plain reference is put in the program's place and
computed one precision lower than the configuration states (its
``control``: int8 retrieval for a bf16 index, TF32 for a float32 one and
for the ranker and the towers), on the cell's own inputs and sizes, and
judged by the same comparison as a run. Training has two faults besides:
``half`` computes each step's loss over the first half of its batch alone;
``solo`` leaves out the exchange between ranks (each rank sees only the
rows it holds). Prints one JSON line
per seed and kind with the compared numbers. The benchmark's runs never
run this; the limits in the configuration files are set from its readings
and from the runs' own.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from perfbench import judge
from perfbench.inputs import serve_inputs
from perfbench.reference import twotower_serve as sref
from perfbench.spec import load_cell
from perfbench.traffic import make_batches


def serve_control(cell, seed: int, device) -> dict:
    """The serve numbers of the lower-precision reference in the
    program's place, over the users a run would check."""
    from perfbench.systems.serve import keep_indices

    cfg, mix = cell.config, cell.traffic
    batch = int(mix["batch"])
    inp = serve_inputs(cfg, seed, device)
    batches = make_batches(mix, seed, {"users": cfg["n_users"], "items": cfg["n_items"]},
                           device)
    users = torch.cat([batches[i]["user"] for i in sorted(keep_indices(
        seed, int(mix["pool"]), batch))])
    low = cfg["control"]
    rows = sref.corpus_rows(inp.item_vecs, inp.item_bias)
    seen = sref.SeenRef(inp.ratings_user, inp.ratings_item, cfg["n_items"])
    pos, vals, ids, scores = [], [], [], []
    k = int(cfg["max_k"])
    with torch.no_grad():
        for s in range(0, users.shape[0], sref.USER_BLOCK):
            u = users[s:s + sref.USER_BLOCK]
            q = sref.user_queries(inp.tower, u, low["ranker"])
            got = sref.retrieve(q, rows, cfg, batch, prec=low["index"])
            fin = sref.final_scores(inp, cfg, u, got.pos, got.vals, seen, low["ranker"])
            sc, sel = torch.topk(fin, k, dim=1)
            pos.append(got.pos)
            vals.append(got.vals)
            ids.append(torch.gather(got.pos + 1, 1, sel))
            scores.append(sc)
        return judge.serve_numbers(inp, cfg, batch, users, torch.cat(pos), torch.cat(vals),
                                   torch.cat(ids), torch.cat(scores), rows, seen)


class _Half(list):
    """Batches of which each step sees the first half."""

    def __getitem__(self, k):
        b = list.__getitem__(self, k)
        return {c: t[: t.shape[0] // 2] for c, t in b.items()}


TRAIN_KINDS = ("control", "half", "solo")


def _train_numbers(cfg: dict, traffic: dict, seed: int, device, what: str, shard: int = 0,
                   group=None) -> dict:
    """One rank's part: the reference in the program's place — at the
    control's precision (``control``), over half of each batch (``half``),
    or without the exchange between ranks, each seeing only its own rows
    (``solo``) — then the reference itself, and the comparison."""
    from perfbench import inputs
    from perfbench.reference import twotower_train as tref
    from perfbench.systems.train import reference

    if what not in TRAIN_KINDS:
        raise ValueError(f"training cells have no {what!r}")
    batches = make_batches(traffic, seed, inputs.train_sizes(cfg), device)
    prec = cfg["control"]["matmul"] if what == "control" else "f32"
    got = tref.run(reference(cfg, seed, shard, device, prec, None if what == "solo" else group),
                   _Half(batches) if what == "half" else batches)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = tref.run(reference(cfg, seed, shard, device, group=group), batches)
    return judge.train_numbers(got, want)


def _rank(rank: int, world: int, port: int, cfg: dict, traffic: dict, seed: int, device: str,
          what: str, queue) -> None:
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        nums = _train_numbers(cfg, traffic, seed, dev, what, rank, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put(nums)


def train_control(cell, seed: int, device, what: str) -> dict:
    """The training numbers of the reference in the program's place, on the
    configuration's mesh: one rank here, or a process a rank."""
    import math
    import multiprocessing as mp

    from perfbench.systems.train import _free_port

    cfg = cell.config
    world = math.prod(cfg["mesh"])
    if world == 1:
        return _train_numbers(cfg, cell.traffic, seed, device, what)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, dict(cfg), dict(cell.traffic),
                                             seed, torch.device(device).type, what, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    nums = queue.get(timeout=1800)
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
            p.join()
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The control of a cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["control"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, Path.cwd())
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for what in args.what:
            if cell.config["system"] == "serve":
                if what != "control":
                    raise ValueError(f"serve cells have no {what!r}")
                nums = serve_control(cell, seed, args.device)
            else:
                nums = train_control(cell, seed, args.device, what)
            chk = judge.checks(nums, cell.config["checks"])
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "correct": judge.passed(chk), "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
