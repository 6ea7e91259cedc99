"""Profiling — program spans, ``torch.profiler`` traces and stage timers
(torch port of ``recommendit_tpu/utils/profiling.py``).

:func:`span` names a stage of the program on the profiler's clock: while a
``torch.profiler`` session records, it opens ``record_function(name)``,
which lands in the Chrome trace beside the device operations launched
inside it (tied to them by their launch records' correlation ids); with no
session recording it returns one shared null context, at the cost of one
flag check. There is no switch: :func:`device_trace`, or any other
profiler session, turns the spans on. :data:`SPANS` names every span the
program opens. Spans nest, and a call's span (``serve.batch``,
``train.step``) holds the spans of its stages on the calling thread.

:func:`device_trace` records a ``torch.profiler`` trace of the block (CPU
activity, and CUDA activity where a card is present) and writes it as a
Chrome trace JSON that Perfetto opens; :func:`time_jitted` keeps JAX's name
and dict, synchronising the card where JAX blocks on the result;
:class:`StageTimer` is a copy of JAX's; :func:`device_loop_time` is the
chained loop timer of the repository's ``bench.py`` (``device_loop_time``),
which the retrieval drivers share.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

# Every span the program opens, by the stage it names.
SPANS = (
    # serving/recommender.py: a serve_batch call and its stages
    "serve.batch", "serve.tower", "serve.retrieve",
    "rank.features", "rank.scorer", "rank.select",
    "serve.copy",                 # the results to the host (_serve_rows)
    # the searchers, inside serve.retrieve (ops/mips_window.py, ops/topk.py)
    "retrieve.score", "retrieve.prune", "retrieve.select",
    # parallel/train.py make_sharded_train_step, parallel/mesh.py apply_
    "train.step", "train.forward", "train.lookup", "train.backward",
    "train.allreduce", "train.optim", "train.clip", "train.adamw",
    # the CTR family: models/ctr.py, training/train_ctr.py
    "ctr::gather", "ctr::towers", "ctr::mlp", "ctr::interaction", "ctr::loss",
    "ctr::softmax", "ctr::adamw", "ctr::sparse_update",
)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a ``torch.profiler`` session records,
    else the one shared null context. ``name`` is one of :data:`SPANS`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN



def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str = "torch-trace", enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the block into
    ``<log_dir>/trace.json`` (open it with Perfetto or chrome://tracing).

    Usage::

        with device_trace("/tmp/trace"):
            train_step(...)
    """
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)


def time_jitted(fn: Callable, *args, iters: int = 50, warmup: int = 2) -> Dict:
    """Steady-state wall time of a callable (median over ``iters`` after
    ``warmup`` calls, the card synchronised after each call) — JAX's name
    and dict."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "median_ms": float(np.median(times) * 1e3),
        "p10_ms": float(np.percentile(times, 10) * 1e3),
        "p90_ms": float(np.percentile(times, 90) * 1e3),
        "iters": iters,
    }


def device_loop_time(step: Callable, q0: torch.Tensor, *args, iters: int = 50,
                     rounds: int = 3, stats: Dict = None) -> float:
    """Seconds per iteration of ``step(q, *args) -> (vals, ...)``, the best
    of ``rounds`` timed rounds of ``iters`` chained iterations after one
    untimed round — ``bench.py::device_loop_time`` without ``jit``.

    Chained as JAX's drivers chain them: each iteration's input is the
    previous one with ``1e-6 · v[:, :1]`` of the previous output ``v``
    added to its first column, in place on a copy of ``q0`` — one launch an
    iteration, so the chain costs little host time beside the step (the
    host enqueues every launch: a step that launches less device work
    than the host's enqueue time is timed at the host's rate, which
    ``stats`` shows) — and each round starts from the last round's start
    moved by ``1e-6 · (acc mod 1 + 1)``, ``acc`` the last round's final
    ``q[0, 0]``. So each call waits for the one before, and no two calls
    get the same f32 inputs unless a step's output is 0 in that column; a
    step that rounds its queries to bf16 loses a move this small, and may
    see equal rounded queries (eager PyTorch caches no result, so that
    costs the timing nothing). A round is timed by CUDA events on the card
    and by the host clock, after the work is done, on the CPU. ``stats``,
    where given, receives each round's ms an iteration (``round_ms``) and
    the host's ms an iteration to enqueue it (``enqueue_ms``; where it is
    as long as the round, the card waited on the host)."""
    cuda = q0.device.type == "cuda"

    def run(q):
        q = q.clone()
        for _ in range(iters):
            out = step(q, *args)
            v = out[0] if isinstance(out, (tuple, list)) else out
            q[:, :1].add_(v[:, :1], alpha=1e-6)
        return q[0, 0].float()

    acc = float(run(q0))                       # warm-up: builds, caches
    round_ms, enqueue_ms = [], []
    for _ in range(rounds):
        q0 = q0 + 1e-6 * (acc % 1.0 + 1.0)
        if cuda:
            torch.cuda.synchronize(q0.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            acc_t = run(q0)
            end.record()
            enqueued = time.perf_counter() - t0
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            acc_t = run(q0)
            seconds = enqueued = time.perf_counter() - t0
        acc = float(acc_t)
        round_ms.append(seconds * 1e3 / iters)
        enqueue_ms.append(enqueued * 1e3 / iters)
    if stats is not None:
        stats.update(round_ms=round_ms, enqueue_ms=enqueue_ms)
    return min(round_ms) / 1e3


class StageTimer:
    """Named stage wall-clock accounting (orchestrator/_timed analogue,
    reusable anywhere)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def report(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self.times.items()}
