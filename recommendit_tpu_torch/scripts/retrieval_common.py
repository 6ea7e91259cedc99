"""What the retrieval drivers (``recall_10m``, ``capacity_30m``,
``recall_curve``, ``bound_turf``, ``mips_ab``, ``fused_decomp``,
``tail_probe``) share: their timer (:func:`timed_ms`, over
``utils/profiling.device_loop_time``), their default report path, outside
the repository, the report writer, and recall against a reference list.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List

import numpy as np


def timed_ms(label: str, step, q0, *args, iters: int, rounds: int) -> float:
    """``device_loop_time``'s best round in ms an iteration, as the report
    gives it; one line on stdout, ``{"timer": label, "round_ms": [...],
    "enqueue_ms": [...]}``, gives every round beside the host's time to
    enqueue it, so a reading's spread and its host-bound rounds show."""
    from recommendit_tpu_torch.utils.profiling import device_loop_time

    stats = {}
    seconds = device_loop_time(step, q0, *args, iters=iters, rounds=rounds, stats=stats)
    print(json.dumps({"timer": label, **stats}), flush=True)
    return seconds * 1e3


def default_out(name: str) -> str:
    """``<temp dir>/recommendit_drivers/<name>``: a driver's default
    ``--out``, never the repository's root, whose JSON files are the JAX
    package's records."""
    return os.path.join(tempfile.gettempdir(), "recommendit_drivers", name)


def write_report(report: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def recall_rows(idx, truth, k: int) -> List[float]:
    """Per row, the share of ``truth``'s k ids that ``idx`` holds, as the
    JAX drivers count it (``len(set(idx[r]) & set(truth[r])) / k``)."""
    idx, truth = np.asarray(idx), np.asarray(truth)
    return [len(set(idx[r].tolist()) & set(truth[r].tolist())) / k
            for r in range(idx.shape[0])]
