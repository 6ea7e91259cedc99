"""The benchmark's files are found by the names in BENCHMARK.json, and a
configuration, a traffic mix and a metric are added as files alone."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.tests.tiny import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.load_cell(workload, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert {"system", "checks", "control", "trace_marker"} <= set(cell.config)
    assert cell.traffic["batch"] > 0
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m.entry["moves"] in names


def test_benchmark_file_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert not m["name"].endswith("roofline") or m["unit"] == "%"


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path / "b")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/twotower-serve-1m.json").read_text())
    cfg["name"] = "throwaway-config"
    (root / "perfbench/configs/throwaway-config.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/throwaway_mix.json").write_text(json.dumps(
        {"loop": "closed", "batch": 7, "pool": 2, "trace_seconds": 1,
         "columns": {"user": {"over": "users", "dist": "uniform"}}}))
    (root / "perfbench/metrics/throwaway.metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.setup_s\n")
    bench["configs"].append({"name": "throwaway-config", "source": "https://example.org",
                             "file": "perfbench/configs/throwaway-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-cell", "config": "throwaway-config",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "test",
                               "moves": "setup_s", "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("throwaway-cell", root)
    assert cell.config["name"] == "throwaway-config" and cell.traffic["batch"] == 7
    assert [m.name for m in cell.per_layer] == ["throwaway.metric"]
    assert [m.name for m in cell.end_to_end] == ["setup_s"]
    ctx = SimpleNamespace(setup_s=1.5)
    assert spec.read_metrics(cell.per_layer, ctx) == {
        "throwaway.metric": {"value": 3.0, "unit": "s"}}


def test_metric_without_reader_is_refused(tmp_path):
    root = tiny_root(tmp_path / "b")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "no.reader", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "test",
                               "moves": "setup_s", "workloads": ["serve1m-b4096"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError):
        spec.load_cell("serve1m-b4096", root)


def test_reader_returning_none_is_left_out():
    m = spec.Metric("x", "ms", {}, lambda ctx: None)
    assert spec.read_metrics([m], None) == {}
