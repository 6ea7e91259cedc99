"""Run a function on every rank of a fresh process group.

:func:`spawn` starts ``nproc`` processes (the ``spawn`` start method: each
imports the function anew, so it must be a module-level function of an
importable module), joins them into one process group through a ``file://``
store in a temporary directory — no TCP port, so concurrent groups on one
host cannot collide — runs ``fn(*args)`` on each, and returns each rank's
result, in rank order. A rank that raises fails the call with its
traceback; a group that outlives ``timeout`` is killed and the call raises
``TimeoutError``, so a hang ends one call and not the program.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from recommendit_tpu_torch.parallel.mesh import distributed_init
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _rank_main(rank: int, fn: Callable, nproc: int, args: Sequence,
               device: str, workdir: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)   # nproc ranks share the host's cores
    distributed_init(f"file://{os.path.join(workdir, 'store')}", nproc, rank,
                     device)
    try:
        result = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nproc: int, args: Sequence = (),
          device=DEFAULT_DEVICE, timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` on each of ``nproc`` ranks → the ranks' results.
    ``device="cuda"`` needs a card a rank (NCCL) and raises otherwise;
    ``device="cpu"`` runs gloo ranks."""
    dev = resolve_device(device).type
    if dev == "cuda" and torch.cuda.device_count() < nproc:
        raise RuntimeError(f"{nproc} ranks on cuda need {nproc} cards, found "
                           f"{torch.cuda.device_count()}: one card a rank")
    with tempfile.TemporaryDirectory(prefix="rank_group_") as workdir:
        ctx = mp.start_processes(_rank_main, args=(fn, nproc, tuple(args), dev, workdir),
                                 nprocs=nproc, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{nproc} ranks of {fn.__qualname__} still running "
                        f"after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for rank in range(nproc):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
