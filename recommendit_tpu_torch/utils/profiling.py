"""Profiling — ``torch.profiler`` traces and stage timers (torch port of
``recommendit_tpu/utils/profiling.py``).

:func:`device_trace` records a ``torch.profiler`` trace of the block (CPU
activity, and CUDA activity where a card is present) and writes it as a
Chrome trace JSON that Perfetto opens; :func:`time_jitted` keeps JAX's name
and dict, synchronising the card where JAX blocks on the result;
:class:`StageTimer` is a copy of JAX's.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


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
