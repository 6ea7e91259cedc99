"""The program's own spans in a traced window: the stages that
``recommendit_tpu_torch.utils.profiling.span`` opens inside a call
(``serve.batch`` and its ``serve.*``, ``retrieve.*``, ``rank.*``;
``train.step`` and its ``train.*``), read from the same Chrome trace as
:mod:`perfbench.trace`.

Every device operation launched inside the ``perfbench.window`` range is
tied to its launch record by its correlation id, as :func:`perfbench.trace.
summarize` ties it (an operation whose launch record is missing takes the
launch of the operation before it on its stream), and counts toward every
program span open on the window's thread at that launch: an operation
launched in ``rank.select`` inside ``serve.batch`` counts toward both. The
device's idle stretches in the window are put, whole, in the spans open on
that thread at each stretch's middle. A program without the spans (or
without :data:`SPANS`) reads nothing, and raises nothing.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence

from perfbench.trace import DEVICE_CATS, LAUNCH_CATS, WINDOW, _ranges, _union


def program_spans() -> tuple:
    """The span names the program under test opens (empty where it names
    none)."""
    try:
        from recommendit_tpu_torch.utils.profiling import SPANS
    except ImportError:
        return ()
    return tuple(SPANS)


@dataclass
class SpanOp:
    name: str
    dur: float                  # µs
    kernel: bool
    spans: FrozenSet[str]       # the program spans open at its launch


@dataclass
class SpanSummary:
    ops: List[SpanOp] = field(default_factory=list)
    idle: Dict[str, float] = field(default_factory=dict)    # span → idle µs
    opened: Dict[str, int] = field(default_factory=dict)    # span → times opened

    def span_s(self, name: str) -> float:
        """Device seconds of the operations launched inside span ``name``."""
        return sum(o.dur for o in self.ops if name in o.spans) / 1e6

    def span_kernels(self, name: str) -> int:
        """Kernels launched inside span ``name``."""
        return sum(1 for o in self.ops if o.kernel and name in o.spans)

    def idle_in_s(self, name: str) -> float:
        """Device idle seconds whose middle fell inside span ``name``."""
        return self.idle.get(name, 0.0) / 1e6


def _active_at(spans, times: Sequence[float]) -> List[FrozenSet[str]]:
    """For each of ``times`` (sorted), the names of the ``spans`` (start,
    end, name) that contain it, ends included."""
    edges = sorted([(a, 0, n) for a, b, n in spans] + [(b, 2, n) for a, b, n in spans])
    open_: Counter = Counter()
    out, j, cache = [], 0, {}
    for t in times:
        while j < len(edges) and (edges[j][0] < t or (edges[j][0] == t and edges[j][1] == 0)):
            _, kind, n = edges[j]
            open_[n] += 1 if kind == 0 else -1
            j += 1
        key = tuple(sorted(n for n, c in open_.items() if c > 0))
        out.append(cache.setdefault(key, frozenset(key)))
    return out


def summarize_spans(events: List[dict], names: Optional[Sequence[str]] = None,
                    window_index: int = -1) -> SpanSummary:
    """The device operations of the ``perfbench.window`` range (the last by
    default) and its idle time, by program span. ``names``: the spans to
    read (default :func:`program_spans`)."""
    names = set(program_spans() if names is None else names)
    wins = _ranges(events, WINDOW)
    if not wins:
        raise ValueError("the trace holds no perfbench.window range")
    w0, w1, tid = wins[window_index]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
             for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in names
             and e.get("tid") == tid and w0 <= float(e["ts"]) <= w1]
    summary = SpanSummary(opened=dict(Counter(n for _, _, n in spans)))
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: (str(e.get("tid")), float(e["ts"])))
    picked, last_launch = [], {}
    for e in dev:
        stream = str(e.get("tid"))
        t = launch.get(e.get("args", {}).get("correlation"), last_launch.get(stream))
        if t is None:
            continue
        last_launch[stream] = t
        if w0 <= t <= w1:
            picked.append((t, e))
    picked.sort(key=lambda te: te[0])
    for (t, e), active in zip(picked, _active_at(spans, [t for t, _ in picked])):
        summary.ops.append(SpanOp(name=str(e.get("name", "")), dur=float(e.get("dur", 0)),
                                  kernel=e.get("cat") == "kernel", spans=active))
    busy = _union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1))
                   for _, e in picked
                   if float(e["ts"]) + float(e.get("dur", 0)) > w0 and float(e["ts"]) < w1])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), active in zip(gaps, _active_at(spans, [(a + b) / 2 for a, b in gaps])):
        for n in active:
            summary.idle[n] = summary.idle.get(n, 0.0) + (b - a)
    return summary
