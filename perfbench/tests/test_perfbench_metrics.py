"""The readers' arithmetic: the tail over every call, the operation and
byte counts behind each roofline against hand counts, and the trace's
reduction on a small hand-made trace."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import spec, trace
from perfbench.tests.tiny import ROOT
from perfbench.window import Call, Window, closed_loop


def reader(name):
    return spec.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", name)


def _window(latencies_ms, rows=10):
    calls, t = [], 0.0
    for ms in latencies_ms:
        calls.append(Call(t, t + 1e-4, t + ms / 1e3, rows))
        t += ms / 1e3
    return Window(t_start=0.0, t_end=t, calls=calls)


def test_p95_is_over_every_call():
    lat = [1.0] * 1900 + [50.0] * 100          # the slow tail comes first
    lat = lat[1900:] + lat[:1900]
    w = _window(lat)
    got = reader("serve_batch_p95_ms").read(SimpleNamespace(window=w))
    assert got == pytest.approx(float(np.percentile(lat, 95)))
    assert got > 1.0       # a tracker of the last 1,000 samples would read 1.0


def test_rate_counts_every_call_over_the_window():
    w = _window([10.0] * 50, rows=4096)
    got = reader("serve_users_per_s").read(SimpleNamespace(window=w))
    assert got == pytest.approx(50 * 4096 / 0.5)


def test_closed_loop_counts_the_last_call():
    seen = []
    w = closed_loop(lambda b: b, [1, 2, 3], 7, 0.02, finish=lambda o: o,
                    on_result=lambda i, o, h: seen.append(i), start=1)
    assert len(w.calls) >= 1 and w.rows == 7 * len(w.calls)
    assert seen[:3] == [1, 2, 0][:len(seen[:3])]
    assert w.t_end >= w.calls[-1].t_done


def test_kernel1_counts():
    k = reader("kernel1_roofline")
    # Q=2 queries, N=16 rows, d=3, W=8: 2·2·16·3 operations; rows 16·3·2 B,
    # queries 2·3·4 B, 2 windows × 2 queries × 8 B
    assert k.ops(2, 16, 3) == 192
    assert k.n_bytes(2, 16, 3, 8) == 96 + 24 + 32
    q, n, d, w = 4096, 1_000_000, 129, 64
    assert k.bound(q, n, d, w) == pytest.approx(2 * q * n * d / 989e12)


def test_bpr_counts():
    b = reader("bpr_roofline")
    # (B, D) = (4096, 128): 2·B²·D and 6·B²·D f32 operations at 67 TFLOP/s
    want = (2 + 6) * 4096**2 * 128 / 67e12
    assert b.bound(4096, 128) == pytest.approx(want)
    # at (2, 4) the bytes bound: (2·2·4·4 + 4) and (4·2·4·4 + 4) bytes
    assert b.bound(2, 4) == pytest.approx((68 + 132) / 3.35e12)


def test_adamw_counts():
    a = reader("adamw_roofline")
    assert a.n_bytes(10) == 280     # 7 f32 passes an element


def test_mfu_counts():
    cfg = {"embedding_dim": 2, "hidden_dim": 3, "n_items": 5, "top_k_candidates": 4,
           "n_features": 6, "ranker_hidden": [3, 2], "genres": 1}
    # B=1: tower 2·(2·3 + 3·2) = 24; scoring 2·5·3 = 30; ranker 2·4·(18+6+2) = 208
    assert reader("serve.mfu").ops(1, cfg) == 24 + 30 + 208
    # B=2: towers 6·2·(6+6) + 6·2·(9+6) = 324; BPR 8·4·2 = 64
    assert reader("train.mfu").ops(2, cfg) == 324 + 64


def _ev(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _trace():
    return [
        _ev("user_annotation", "perfbench.window", 0, 100),
        _ev("user_annotation", "perfbench.batch", 0, 40),
        _ev("user_annotation", "perfbench.retrieve", 5, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _ev("kernel", "void tc::window_tc_kernel<64, false, false>(x)", 10, 20, tid=7, corr=1),
        _ev("kernel", "elementwise_kernel", 30, 10, tid=7, corr=2),
        _ev("kernel", "no_launch_record", 40, 5, tid=7, corr=99),
        _ev("user_annotation", "perfbench.batch", 50, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=3),
        _ev("kernel", "elementwise_kernel", 60, 30, tid=7, corr=3),
        _ev("cpu_op", "aten::mm", 51, 5),
        _ev("kernel", "outside_the_window", 200, 10, tid=7, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=4),
    ]


def test_trace_reduction():
    s = trace.summarize(_trace())
    assert s.window_s == pytest.approx(100e-6) and s.n_calls == 2
    assert len(s.ops) == 4                      # the one outside the window left out
    assert s.count("window_tc_kernel") == 1
    assert s.layer_s("retrieve") == pytest.approx(20e-6)
    # outside the layer: 10 + 5 (its launch record missing: the previous op's) + 30
    assert s.layer_s(None) == pytest.approx(45e-6)
    assert s.busy_s == pytest.approx(65e-6)     # [10, 45] and [60, 90]
    gaps = dict(s.breakdown["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(15e-6)       # 45..60
    assert sum(gaps.values()) == pytest.approx(35e-6)
    ops = dict(s.breakdown["device_ops"])
    assert ops["tc::window_tc_kernel"] == pytest.approx(20e-6)


def test_device_readers_on_the_hand_trace():
    s = trace.summarize(_trace())
    ctx = SimpleNamespace(trace=s, whole=1, window=None, facts={})
    assert reader("retrieve.device_ms").read(ctx) == pytest.approx(0.020)
    assert reader("rank.device_ms").read(ctx) == pytest.approx(0.045)
    assert reader("serve.idle_share").read(ctx) == pytest.approx(35.0)
    assert reader("retrieve.device_ms").read(SimpleNamespace(trace=None, whole=None)) is None
