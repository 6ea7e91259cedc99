"""The one traffic generator: a mix file of parameters → batches of ids.

A mix (``perfbench/traffic/<name>.json``) holds:

* ``loop``: ``"closed"`` — one call in flight; the next is made when the
  last one's results are back (serving) or enqueued (training);
* ``batch``: rows a call;
* ``pool``: distinct batches drawn from the seed; the window cycles through
  them in order, so every seed gives the same sizes and the same amount of
  work, with other ids;
* ``columns``: ``{column: {"over": range, "dist": "uniform"}}`` — each
  column's ids drawn uniformly from 1 to the system's size named by
  ``over`` (``users``, ``items``), with replacement;
* ``trace_seconds``: the length of the traced window of a ``--trace 1`` run.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.seeds import generator

DISTS = ("uniform",)


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed":
        raise ValueError(f"unsupported loop {mix.get('loop')!r}")
    for col, spec in mix["columns"].items():
        if spec.get("dist", "uniform") not in DISTS:
            raise ValueError(f"column {col}: unsupported dist {spec.get('dist')!r}")
    if int(mix["batch"]) < 1 or int(mix["pool"]) < 1:
        raise ValueError("batch and pool must be positive")


def make_batches(mix: dict, seed: int, sizes: Dict[str, int],
                 device) -> List[Dict[str, torch.Tensor]]:
    """The mix's pool of batches for ``seed``: a list of ``pool`` dicts of
    (batch,) int64 id tensors on ``device``, one a column; ``sizes`` maps a
    column's ``over`` to its largest id."""
    check_mix(mix)
    b, pool = int(mix["batch"]), int(mix["pool"])
    out = []
    for k in range(pool):
        batch = {}
        for col, spec in sorted(mix["columns"].items()):
            hi = int(sizes[spec["over"]])
            gen = generator(device, seed, "traffic", col, k)
            batch[col] = torch.randint(1, hi + 1, (b,), generator=gen, device=device)
        out.append(batch)
    return out
