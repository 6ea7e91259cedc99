"""The measured window: a closed loop over a pool of batches, timed by the
host's clock."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class Call:
    t_call: float      # host clock at the call
    t_return: float    # ... when the call returned (work enqueued)
    t_done: float      # ... when its results were on the host (or = t_return)
    rows: int          # users served or examples trained


@dataclass
class Window:
    t_start: float
    t_end: float = 0.0
    calls: List[Call] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def rows(self) -> int:
        return sum(c.rows for c in self.calls)


def _range(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def closed_loop(call: Callable, batches: Sequence, rows: int, seconds: float,
                finish: Optional[Callable] = None, drain: Optional[Callable] = None,
                on_result: Optional[Callable] = None, ranges: bool = False,
                start: int = 0) -> Window:
    """Call ``call(batches[i % len])`` one at a time until ``seconds`` of
    host time have passed since the first call; ``finish(out)`` brings each
    result to the host before the next call (serving), and ``drain()``
    waits for whatever is still running after the last one (training).
    The window ends when the last result is in; every call made counts.
    The first call takes batch ``start``.
    ``on_result(i, out, host)`` sees each call's pool index and results.
    With ``ranges`` each call sits in a ``perfbench.batch`` profiler range
    and the loop in ``perfbench.window``."""
    with _range("perfbench.window", ranges):
        win = Window(t_start=time.perf_counter())
        stop = win.t_start + seconds
        i = start
        while True:
            t_call = time.perf_counter()
            if t_call >= stop and win.calls:
                break
            batch = batches[i % len(batches)]
            with _range("perfbench.batch", ranges):
                out = call(batch)
            t_return = time.perf_counter()
            host = finish(out) if finish is not None else None
            t_done = time.perf_counter() if finish is not None else t_return
            win.calls.append(Call(t_call, t_return, t_done, rows))
            if on_result is not None:
                on_result(i % len(batches), out, host)
            i += 1
        if drain is not None:
            drain()
        win.t_end = time.perf_counter()
    return win
