"""The port's micro-batcher (``recommendit_tpu_torch/serving/batcher.py``), a
copy of the JAX package's: its code pinned to the original (everything but
the module docstring, compared as syntax trees), and the JAX batcher's unit
cases (``tests/test_batcher.py``: coalescing, the max-batch trigger, error
propagation, timeouts, backpressure, deadlines and expiry, stats), each run
against both modules. The pipeline's use of it is in
``tests/test_torch_app.py``. Also the kernel wrappers' launch counts, which
the batcher's, HTTP and calibration threads may add to at once: no update
lost under a short switch interval."""
import ast
import sys
import threading
import time
from pathlib import Path

import pytest

from recommendit_tpu.serving import batcher as jax_batcher
from recommendit_tpu_torch.serving import batcher as port_batcher

ROOT = Path(__file__).resolve().parent.parent
MODULES = {"jax": jax_batcher, "port": port_batcher}


def _body(path: Path) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def test_code_is_the_jax_code():
    assert _body(ROOT / "recommendit_tpu_torch/serving/batcher.py") == _body(
        ROOT / "recommendit_tpu/serving/batcher.py")


@pytest.fixture(params=sorted(MODULES))
def mod(request):
    return MODULES[request.param]


def test_single_request(mod):
    b = mod.MicroBatcher(lambda ids: [i * 10 for i in ids], max_wait_ms=1)
    try:
        assert b.submit(7) == 70
    finally:
        b.close()


def test_concurrent_requests_coalesce(mod):
    calls = []

    def batch_fn(ids):
        calls.append(list(ids))
        time.sleep(0.01)
        return [i + 1000 for i in ids]

    b = mod.MicroBatcher(batch_fn, max_batch=64, max_wait_ms=20)
    try:
        results = {}

        def worker(uid):
            results[uid] = b.submit(uid)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert results == {i: i + 1000 for i in range(32)}
        assert b.batches_dispatched < 32
        assert b.stats["avg_batch_size"] > 1.5
        assert sorted(i for c in calls for i in c) == list(range(32))
    finally:
        b.close()


def test_max_batch_triggers_dispatch(mod):
    b = mod.MicroBatcher(lambda ids: ids, max_batch=4, max_wait_ms=5000)
    try:
        results = []
        threads = [threading.Thread(target=lambda i=i: results.append(b.submit(i)))
                   for i in range(4)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3)
        # dispatched well before the 5 s wait because the batch filled
        assert time.monotonic() - t0 < 2.0
        assert sorted(results) == [0, 1, 2, 3]
    finally:
        b.close()


def test_error_propagates_to_all_waiters(mod):
    def boom(ids):
        raise RuntimeError("backend down")

    b = mod.MicroBatcher(boom, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="backend down"):
            b.submit(1)
    finally:
        b.close()


def test_timeout(mod):
    b = mod.MicroBatcher(lambda ids: time.sleep(5) or ids, max_wait_ms=1)
    try:
        with pytest.raises(TimeoutError):
            b.submit(1, timeout=0.2)
    finally:
        b.close()


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_queue_full_raises(mod):
    """Two requests held by the dispatch thread, three in the queue: the
    next submit is rejected at once, and only it."""
    release = threading.Event()
    held = []

    def slow_fn(ids):
        held.append(list(ids))
        release.wait(10.0)
        return [i * 2 for i in ids]

    # a long wait: the first batch dispatches when its second request comes
    b = mod.MicroBatcher(slow_fn, max_batch=2, max_wait_ms=2000.0, max_queue=3)
    threads = [threading.Thread(target=lambda: b.submit(1, timeout=10.0))
               for _ in range(5)]
    try:
        for t in threads[:2]:
            t.start()
        _wait_for(lambda: held == [[1, 1]])
        for t in threads[2:]:
            t.start()
        _wait_for(lambda: b.stats["queue_depth"] == 3)
        with pytest.raises(mod.QueueFullError):
            b.submit(99, timeout=5.0)
        assert b.requests_rejected == 1
    finally:
        release.set()
        for t in threads:
            t.join(timeout=10.0)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert b.requests_served == 5


def test_expired_requests_never_reach_the_batch_fn(mod):
    seen = []
    release = threading.Event()
    first_in = threading.Event()

    def fn(ids):
        first_in.set()
        release.wait(5.0)
        seen.extend(ids)
        return list(ids)

    b = mod.MicroBatcher(fn, max_batch=1, max_wait_ms=0.5)
    try:
        t1 = threading.Thread(target=lambda: b.submit(1, timeout=5.0))
        t1.start()
        assert first_in.wait(2.0)
        with pytest.raises(TimeoutError):
            b.submit(2, timeout=0.2)
        time.sleep(0.1)
        release.set()
        t1.join(timeout=5.0)
        time.sleep(0.3)   # let the loop drain the expired entry
        assert 2 not in seen
        assert b.requests_expired >= 1
    finally:
        release.set()
        b.close()


def test_stats_surface(mod):
    b = mod.MicroBatcher(lambda ids: ids, max_batch=4)
    try:
        assert b.submit(7, timeout=2.0) == 7
        st = b.stats
        assert set(st) == {"batches_dispatched", "requests_served",
                           "requests_rejected", "requests_expired",
                           "queue_depth", "avg_batch_size"}
        assert st["requests_served"] == 1 and st["requests_rejected"] == 0
    finally:
        b.close()


def test_launch_counts_lose_no_update_across_threads():
    from recommendit_tpu_torch.ops._build import count_launch

    counts = {"window_mips": 0}

    def launch():
        for _ in range(20_000):
            count_launch(counts, "window_mips")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["window_mips"] == 16 * 20_000
