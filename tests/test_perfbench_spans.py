"""``perfbench/spans.py`` on hand-made Chrome-trace events: device time put
in every program span open at an operation's launch, idle time in the
spans open at an idle stretch's middle; and the benchmark's own reduction
(``perfbench/trace.py``) reading the same with the program's spans in the
trace as without them."""
import pytest

from perfbench import spans, trace

NAMES = ("serve.batch", "serve.retrieve", "retrieve.score", "rank.select")


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr)


def _kernel(name, ts, dur, corr):
    return _ev("kernel", name, ts, dur, tid=7, corr=corr)


def _bench_events():
    """Two calls in the window; the benchmark's ranges and the device ops."""
    return [
        _ev("user_annotation", "perfbench.window", 0, 200),
        _ev("user_annotation", "perfbench.batch", 0, 90),
        _ev("user_annotation", "perfbench.retrieve", 10, 30),
        _launch(12, 1), _kernel("window_tc_kernel", 15, 20, 1),
        _launch(30, 2), _kernel("topk_kernel", 35, 5, 2),
        _launch(50, 3), _ev("gpu_memcpy", "Memcpy DtoH", 60, 10, tid=7, corr=3),
        _launch(70, 4), _kernel("elementwise_kernel", 80, 10, 4),
        _kernel("no_launch_record", 90, 4, 99),
        _ev("user_annotation", "perfbench.batch", 100, 90),
        _launch(105, 5), _kernel("elementwise_kernel", 120, 30, 5),
        _ev("cpu_op", "aten::mm", 101, 10),
        _launch(300, 6), _kernel("outside_the_window", 310, 10, 6),
    ]


def _program_events():
    """The program's spans of the first call: serve.batch ⊃ serve.retrieve
    ⊃ retrieve.score, then rank.select; and of the second call's
    serve.batch; one span on another thread."""
    return [
        _ev("user_annotation", "serve.batch", 1, 88),
        _ev("user_annotation", "serve.retrieve", 11, 28),
        _ev("user_annotation", "retrieve.score", 11, 10),
        _ev("user_annotation", "rank.select", 45, 40),
        _ev("user_annotation", "serve.batch", 101, 50),
        _ev("user_annotation", "rank.select", 0, 200, tid=2),
    ]


def test_device_time_counts_toward_every_enclosing_span():
    s = spans.summarize_spans(_bench_events() + _program_events(), NAMES)
    assert s.opened == {"serve.batch": 2, "serve.retrieve": 1, "retrieve.score": 1,
                        "rank.select": 1}
    # the kernel launched at 12 (20 µs) in retrieve.score, serve.retrieve and
    # serve.batch; the one at 30 (5) outside retrieve.score
    assert s.span_s("retrieve.score") == pytest.approx(20e-6)
    assert s.span_s("serve.retrieve") == pytest.approx(25e-6)
    # rank.select: the copy (10), the kernel (10) and the op with no launch
    # record, which takes the one before it on its stream (4)
    assert s.span_s("rank.select") == pytest.approx(24e-6)
    assert s.span_kernels("rank.select") == 2
    # serve.batch: both calls, 49 + 30 µs; the op outside the window left out
    assert s.span_s("serve.batch") == pytest.approx(79e-6)
    assert s.span_kernels("serve.batch") == 5
    # a span another thread opened holds nothing
    assert len(s.ops) == 6


def test_idle_time_inside_and_outside_a_span():
    s = spans.summarize_spans(_bench_events() + _program_events(), NAMES)
    # busy: [15, 40], [60, 70], [80, 94], [120, 150]; idle: 0-15 (middle 7.5:
    # serve.batch from 1), 40-60 and 70-80 (in rank.select), 94-120 (107: the
    # second serve.batch), 150-200 (175: no span)
    assert s.idle_in_s("serve.batch") == pytest.approx((15 + 20 + 10 + 26) * 1e-6)
    assert s.idle_in_s("rank.select") == pytest.approx(30e-6)
    assert s.idle_in_s("serve.retrieve") == 0.0
    assert s.idle_in_s("retrieve.score") == 0.0


def test_no_program_spans_reads_nothing():
    s = spans.summarize_spans(_bench_events(), NAMES)
    assert s.opened == {} and s.span_s("serve.batch") == 0.0 and not s.idle
    assert len(s.ops) == 6 and all(not o.spans for o in s.ops)


def test_names_default_to_the_program():
    from recommendit_tpu_torch.utils.profiling import SPANS

    assert spans.program_spans() == SPANS
    s = spans.summarize_spans(_bench_events() + _program_events())
    assert s.opened["serve.batch"] == 2


def test_the_benchmark_reads_the_same_with_program_spans():
    bare = trace.summarize(_bench_events())
    both = trace.summarize(_bench_events() + _program_events())
    for layer in (None, "retrieve"):
        assert both.layer_s(layer) == bare.layer_s(layer)
    assert (both.busy_s, both.n_calls, both.window_s) == (bare.busy_s, bare.n_calls,
                                                          bare.window_s)
    for pattern in ("window_tc_kernel", "Memcpy DtoH", "elementwise", ""):
        assert both.count(pattern) == bare.count(pattern)
        assert both.kernel_s(pattern) == bare.kernel_s(pattern)
    assert both.breakdown["device_ops"] == bare.breakdown["device_ops"]
    assert [(o.name, o.batch, o.layer) for o in both.ops] == \
        [(o.name, o.batch, o.layer) for o in bare.ops]
