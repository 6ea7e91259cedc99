"""Request micro-batcher — torch port (a copy of
``recommendit_tpu/serving/batcher.py``; ``tests/test_torch_batcher.py``
pins its code to the original).

A single-request serve call costs nearly the device time of a batch, and
only batches of 384 users or more take the window kernel. The
micro-batcher coalesces concurrent HTTP requests into one ``serve_batch``
call: requests enqueue, the dispatch thread drains the queue every
``max_wait_ms`` or as soon as ``max_batch`` are waiting, and each caller
gets its row back through a per-request event.

- **Backpressure**: the queue is bounded (``max_queue``); when the device
  cannot drain it fast enough, ``submit`` fails at once with
  :class:`QueueFullError` instead of growing an unbounded latency tail —
  the HTTP layer maps it to 429.
- **Deadline propagation**: every request carries an absolute deadline.
  Requests that expire while queued are failed without spending device
  time on them, and the dispatch loop never waits for stragglers past the
  earliest deadline in the batch.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

logger = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """Raised by submit() when the batcher queue is at capacity
    (backpressure signal — callers should shed load / return 429)."""


@dataclass
class _Pending:
    user_id: int
    deadline: float  # absolute monotonic time
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesces scalar requests into batched backend calls.

    Args:
        batch_fn: callable taking a list of user ids → sequence of
            per-user results (ordered).
        max_batch: dispatch immediately once this many requests wait.
        max_wait_ms: dispatch whatever is queued after this long.
        max_queue: queue capacity before submit() raises QueueFullError
            (default: 8 full batches of headroom).
    """

    def __init__(
        self,
        batch_fn: Callable[[List[int]], Sequence[Any]],
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        max_queue: Optional[int] = None,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue = max_queue or max_batch * 8
        self._queue: "queue.Queue[_Pending]" = queue.Queue(self.max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.batches_dispatched = 0
        self.requests_served = 0
        self.requests_rejected = 0
        self.requests_expired = 0

    # ------------------------------------------------------------------ #

    def submit(self, user_id: int, timeout: float = 10.0) -> Any:
        """Enqueue a request and block until its result is ready.

        ``timeout`` doubles as the request's deadline budget: if it cannot
        be served within it, the request is dropped before reaching the
        device. Raises QueueFullError immediately under backpressure.
        """
        p = _Pending(user_id=user_id, deadline=time.monotonic() + timeout)
        try:
            self._queue.put_nowait(p)
        except queue.Full:
            self.requests_rejected += 1
            raise QueueFullError(
                f"micro-batch queue at capacity ({self.max_queue})"
            ) from None
        if not p.event.wait(timeout):
            raise TimeoutError(f"batched request for user {user_id} timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    @property
    def stats(self) -> dict:
        return {
            "batches_dispatched": self.batches_dispatched,
            "requests_served": self.requests_served,
            "requests_rejected": self.requests_rejected,
            "requests_expired": self.requests_expired,
            "queue_depth": self._queue.qsize(),
            "avg_batch_size": (
                self.requests_served / max(1, self.batches_dispatched)
            ),
        }

    # ------------------------------------------------------------------ #

    def _expire(self, p: _Pending, now: float) -> bool:
        """Fail an already-expired request without device work."""
        if p.deadline <= now:
            p.error = TimeoutError(
                f"request for user {p.user_id} expired in queue"
            )
            p.event.set()
            self.requests_expired += 1
            return True
        return False

    def _drain(self) -> List[_Pending]:
        """Collect up to max_batch live requests; never wait for stragglers
        past max_wait or past the earliest deadline in the batch."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        now = time.monotonic()
        if self._expire(first, now):
            return []
        batch = [first]
        hard_stop = min(now + self.max_wait_s, first.deadline)
        while len(batch) < self.max_batch:
            now = time.monotonic()
            remaining = hard_stop - now
            if remaining <= 0:
                break
            try:
                p = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._expire(p, time.monotonic()):
                continue
            batch.append(p)
            hard_stop = min(hard_stop, p.deadline)
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                results = self.batch_fn([p.user_id for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as exc:  # propagate to every waiter
                for p in batch:
                    p.error = exc
            finally:
                self.batches_dispatched += 1
                self.requests_served += len(batch)
                for p in batch:
                    p.event.set()
