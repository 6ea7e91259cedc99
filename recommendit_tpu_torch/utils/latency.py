"""Rolling-window latency percentile tracker — the port's copy of
``recommendit_tpu/utils/latency.py`` (pinned to it by
``tests/test_torch_config.py``).

record / percentile / p50 / p99 / count over a 1000-sample window, O(1)
amortized via a ring buffer.
"""
from __future__ import annotations

import numpy as np


class LatencyTracker:
    def __init__(self, window: int = 1000):
        self.window = window
        self._buf = np.zeros(window, dtype=np.float64)
        self._n = 0          # total samples seen
        self._pos = 0        # next write position

    def record(self, latency_ms: float) -> None:
        self._buf[self._pos] = latency_ms
        self._pos = (self._pos + 1) % self.window
        self._n += 1

    def _valid(self) -> np.ndarray:
        return self._buf[: min(self._n, self.window)]

    def percentile(self, p: float) -> float:
        v = self._valid()
        if v.size == 0:
            return 0.0
        return float(np.percentile(v, p))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def count(self) -> int:
        return min(self._n, self.window)
