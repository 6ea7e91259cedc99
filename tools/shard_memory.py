"""Peak device memory of one rank of a sharded two-tower run, in the two
memory plans of its step, on one card: ``chunked`` — ``OptaxAdamW.step``
a chunk at a time and ``sharded_grads`` in place, the plan of JAX's
donated step — and ``one-pass`` — ``OptaxAdamW._step_unchunked`` (every
temporary a full-size copy of the params, four of them alive at the
decay: the squares, denominators, update and decay product) and
``_sharded_grads_flat`` (every gradient copied into one flat buffer), the
plan the port had before. Each (layout, plan) runs in a fresh process
(one NCCL rank, so the allocator starts empty): ``scale_smoke.train_shard``
on a (1, 1) mesh holding the rows one rank of ``--of-shards`` holds,
``--steps`` steps. A plan that runs out of memory is reported as such,
with the peak reached.
A measurement tool, outside the package: nothing imports it.

    python3 tools/shard_memory.py [--config web100m] [--of-shards 8,4] [--steps 2]

Prints the card's name and power limit and one JSON line per (layout,
plan): state (params + grads + two moments), peak allocated, peak over
state, ms a step, or the out-of-memory error.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

PLANS = ("chunked", "one-pass")


def rank(config: str, of_shards: int, plan: str, steps: int) -> dict:
    from recommendit_tpu_torch.parallel import create_mesh
    from recommendit_tpu_torch.parallel import train as ptrain
    from recommendit_tpu_torch.scripts.scale_smoke import train_shard
    from recommendit_tpu_torch.training.train_embeddings import OptaxAdamW

    if plan == "one-pass":
        OptaxAdamW.step = OptaxAdamW._step_unchunked
        ptrain.sharded_grads = ptrain._sharded_grads_flat
    mesh = create_mesh(shape=(1, 1))
    try:
        return train_shard(mesh, config, full=True, of_shards=of_shards, steps=steps)
    except torch.cuda.OutOfMemoryError as exc:
        return {"out_of_memory": str(exc).splitlines()[0],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="web100m")
    ap.add_argument("--of-shards", default="8,4")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_memory: no CUDA device", file=sys.stderr)
        return 2
    from recommendit_tpu_torch.parallel.launch import spawn

    print(chip_smoke.card_line(), flush=True)
    for of_shards in (int(x) for x in args.of_shards.split(",")):
        for plan in PLANS:
            rec = spawn(rank, 1, (args.config, of_shards, plan, args.steps),
                        device="cuda", timeout=900)[0]
            rec = {k: v for k, v in rec.items() if k != "losses"}
            if "state_gib" in rec:
                rec["peak_over_state_gib"] = rec["peak_gib"] - rec["state_gib"]
            print(json.dumps({"of_shards": of_shards, "plan": plan, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
