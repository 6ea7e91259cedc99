"""Run a function on every rank of a fresh process group.

:func:`spawn` starts ``nproc`` processes (the ``spawn`` start method: each
imports the function anew, so it must be a module-level function of an
importable module), joins them into one process group through a ``file://``
store in a temporary directory — no TCP port, so concurrent groups on one
host cannot collide — runs ``fn(*args)`` on each, and returns each rank's
result, in rank order.

Each rank leaves records in that directory as it goes: ``rank<r>.joined``
(the seconds it took to join the group) once it is in the group,
``rank<r>.pkl`` (its result) once ``fn`` returned, ``rank<r>.err`` (its
traceback) where it raised. A rank that fails or ends without its result
raises :class:`SpawnError`, and a group that outlives ``timeout`` is killed
and raises :class:`SpawnTimeout` (a ``TimeoutError``). Both messages give
the rendezvous state from those records — each rank's exit code or signal,
whether it joined the group and returned, and every traceback — read after
the other ranks had ``GRACE_S`` seconds to end too, so the first failure
does not hide the others' state.
"""
from __future__ import annotations

import ctypes
import multiprocessing.connection
import os
import pickle
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from recommendit_tpu_torch.parallel.mesh import distributed_init
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

GRACE_S = 5.0     # how long the other ranks may run on after one has failed
_PR_SET_PDEATHSIG = 1


class SpawnError(RuntimeError):
    """A rank failed or ended without its result; the message holds every
    rank's state and traceback."""


class SpawnTimeout(SpawnError, TimeoutError):
    """The group outlived its timeout and was killed."""


def _record(workdir: str, rank: int, kind: str) -> str:
    return os.path.join(workdir, f"rank{rank}.{kind}")


def _write(path: str, data: bytes) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def _die_with_parent() -> None:
    """SIGKILL this process when the thread that started it ends (Linux's
    parent-death signal; that thread waits in :func:`spawn` until the ranks
    end), so no rank outlives a killed caller. Unlike torch's
    ``start_processes`` (SIGINT, then an exit with code 0 and no result),
    a rank so ended is reported by its signal."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _rank_main(rank: int, fn: Callable, nproc: int, args: Sequence,
               device: str, workdir: str) -> None:
    _die_with_parent()
    t0 = time.monotonic()
    try:
        if device == "cpu":
            torch.set_num_threads(1)   # nproc ranks share the host's cores
        distributed_init(f"file://{os.path.join(workdir, 'store')}", nproc, rank,
                         device)
        _write(_record(workdir, rank, "joined"), f"{time.monotonic() - t0:.2f}".encode())
        try:
            result = fn(*args)
            _write(_record(workdir, rank, "pkl"), pickle.dumps(result))
        finally:
            dist.destroy_process_group()
    except BaseException:
        _write(_record(workdir, rank, "err"), traceback.format_exc().encode())
        raise


def _read(path: str):
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")
    except FileNotFoundError:
        return None


def _state(procs, workdir: str, t0: float) -> str:
    """The rendezvous state: the store, and each rank's exit, records and
    traceback."""
    try:
        store = f"{os.path.getsize(os.path.join(workdir, 'store'))} bytes"
    except FileNotFoundError:
        store = "absent"
    lines = [f"{time.monotonic() - t0:.1f} s after the start; store {store}"]
    for rank, p in enumerate(procs):
        code = p.exitcode
        ended = ("running" if code is None else
                 f"killed by signal {-code}" if code < 0 else f"exit code {code}")
        joined = _read(_record(workdir, rank, "joined"))
        lines.append(
            f"rank {rank} (pid {p.pid}): {ended}; "
            + (f"joined the group after {joined} s" if joined else "never joined the group")
            + ("; returned its result" if os.path.exists(_record(workdir, rank, "pkl"))
               else "; no result"))
        err = _read(_record(workdir, rank, "err"))
        if err:
            lines.append("  " + err.rstrip().replace("\n", "\n  "))
    return "\n".join(lines)


def _wait(procs, deadline: float) -> bool:
    """Wait until every rank has ended, or one has failed and the rest had
    ``GRACE_S`` more, or the deadline → whether the deadline passed with
    no rank failed."""
    grace_end = None
    while True:
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return False
        now = time.monotonic()
        if grace_end is None and any(p.exitcode for p in procs):
            grace_end = now + GRACE_S
        if grace_end is not None and now >= grace_end:
            return False
        if now >= deadline:
            return grace_end is None
        end = deadline if grace_end is None else min(deadline, grace_end)
        multiprocessing.connection.wait([p.sentinel for p in alive], end - now)


def spawn(fn: Callable, nproc: int, args: Sequence = (),
          device=DEFAULT_DEVICE, timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` on each of ``nproc`` ranks → the ranks' results.
    ``device="cuda"`` needs a card a rank (NCCL) and raises otherwise;
    ``device="cpu"`` runs gloo ranks."""
    dev = resolve_device(device).type
    if dev == "cuda" and torch.cuda.device_count() < nproc:
        raise RuntimeError(f"{nproc} ranks on cuda need {nproc} cards, found "
                           f"{torch.cuda.device_count()}: one card a rank")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rank_group_",
                                     ignore_cleanup_errors=True) as workdir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(r, fn, nproc, tuple(args), dev, workdir))
                 for r in range(nproc)]
        t0 = time.monotonic()
        try:
            for p in procs:
                p.start()
            what = f"{nproc} ranks of {fn.__qualname__}"
            if _wait(procs, t0 + timeout):
                raise SpawnTimeout(f"{what} still running after {timeout:.0f} s:\n"
                                   + _state(procs, workdir, t0))
            missing = [r for r in range(nproc)
                       if not os.path.exists(_record(workdir, r, "pkl"))]
            if missing:
                raise SpawnError(f"{what}: ranks {missing} have no result:\n"
                                 + _state(procs, workdir, t0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for rank in range(nproc):
            with open(_record(workdir, rank, "pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
