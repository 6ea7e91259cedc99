"""The device trace of a traced window, by ``torch.profiler``, reduced to
what the per-layer metrics read.

The profiler's Chrome trace is read back, and every device operation
(kernel, copy, fill) is tied to the host range it was launched in through
its launch record's correlation id; an operation whose launch record is
missing takes the range of the operation before it on its stream. The
harness opens ``perfbench.window`` around the traced loop,
``perfbench.batch`` around each call, and ``perfbench.<layer>`` around the
calls into a layer that a metric reads.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW, BATCH = "perfbench.window", "perfbench.batch"
TOP = 10
_SCAN_BACK = 5000


@dataclass
class DeviceOp:
    name: str
    ts: float          # µs, device start
    dur: float         # µs
    kernel: bool
    batch: Optional[int] = None   # index of the perfbench.batch range it was launched in
    layer: Optional[str] = None   # the innermost perfbench.<layer> range, if any


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_calls: int
    ops: List[DeviceOp] = field(default_factory=list)
    breakdown: dict = field(default_factory=dict)

    def count(self, pattern: str) -> int:
        """Device operations (kernels, copies) launched in the window whose
        name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(1 for o in self.ops if rx.search(o.name))

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(o.dur for o in self.ops if o.kernel and rx.search(o.name)) / 1e6

    def layer_s(self, layer: Optional[str]) -> float:
        """Device seconds of the operations launched in a call's range and
        inside the ``perfbench.<layer>`` range (``None``: outside every
        layer range)."""
        return sum(o.dur for o in self.ops
                   if o.layer == layer and o.batch is not None) / 1e6


def _strip_templates(name: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def short_name(name: str) -> str:
    """A kernel's or host event's name without its return type, template
    arguments and parameters: ``void ns::k<T>(args)`` → ``ns::k``."""
    n = _strip_templates(name.replace("(anonymous namespace)::", ""))
    head = n.split("(")[0].strip() or n.strip()
    words = head.split()
    if len(words) > 1 and (words[0] == "void" or "::" in words[-1]):
        head = words[-1]
    return head[:64]


@contextlib.contextmanager
def capture(sync):
    """Profile the block (host and CUDA activity); afterwards the holder's
    ``"events"`` are the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder: Dict[str, list] = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        sync()
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["events"] = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof, torch


def _ranges(events, name: str) -> List[Tuple[float, float, int]]:
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
           for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    return sorted(out)


def _containing(ranges: List[Tuple[float, float, str]], t: float) -> Optional[int]:
    """Index of the latest-starting range that contains ``t``."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    while i >= 0:
        if ranges[i][0] <= t <= ranges[i][1]:
            return i
        if t - ranges[i][0] > 60e6:
            break
        i -= 1
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], window_index: int = -1) -> TraceSummary:
    """Reduce the trace to the device operations launched inside the
    ``perfbench.window`` range (the last one by default)."""
    wins = _ranges(events, WINDOW)
    if not wins:
        raise ValueError("the trace holds no perfbench.window range")
    w0, w1, main_tid = wins[window_index]
    batches = [(a, b, "") for a, b, _ in _ranges(events, BATCH) if w0 <= a <= w1]
    layers = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("perfbench.")
                    and e["name"] not in (WINDOW, BATCH))
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: (str(e.get("tid")), float(e["ts"])))
    ops: List[DeviceOp] = []
    last_launch: Dict[str, float] = {}
    for e in dev:
        stream = str(e.get("tid"))
        t = launch.get(e.get("args", {}).get("correlation"), last_launch.get(stream))
        if t is None:
            continue
        last_launch[stream] = t
        if not (w0 <= t <= w1):
            continue
        li = _containing(layers, t)
        ops.append(DeviceOp(
            name=str(e.get("name", "")), ts=float(e["ts"]), dur=float(e.get("dur", 0)),
            kernel=e.get("cat") == "kernel", batch=_containing(batches, t),
            layer=layers[li][2][len("perfbench."):] if li is not None else None))
    busy = _union([(max(o.ts, w0), min(o.ts + o.dur, w1)) for o in ops
                   if o.ts + o.dur > w0 and o.ts < w1])
    busy_s = sum(b - a for a, b in busy) / 1e6
    summary = TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_s,
                           n_calls=len(batches), ops=ops)
    summary.breakdown = {"device_ops": _top_ops(ops),
                         "idle_gaps": _idle_gaps(events, busy, w0, w1, main_tid)}
    return summary


def _top_ops(ops: List[DeviceOp]) -> List[list]:
    by: Dict[str, float] = {}
    for o in ops:
        k = short_name(o.name)
        by[k] = by.get(k, 0.0) + o.dur / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _idle_gaps(events, busy, w0: float, w1: float, tid) -> List[list]:
    """The device's idle time in the window, summed by the innermost host
    event (on the window's thread) at each gap's middle."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e["name"]))
                  for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid)
    starts = [h[0] for h in host]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    by: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "_between_host_events_"
        for j in range(i, max(-1, i - _SCAN_BACK), -1):
            if host[j][1] >= mid:
                name = short_name(host[j][2])
                break
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
