"""Small copies of the benchmark's cells, for the CPU tests: the same
files and metric readers in a directory of their own, with the
configurations cut to a size a test run holds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "twotower-serve-1m": {"n_users": 60, "n_items": 16384, "n_ratings": 4000},
    "twotower-serve-1m-exact": {"n_users": 60, "n_items": 16384, "n_ratings": 4000},
    "web100m-rank": {"n_users": 4000, "n_items": 3000},
    "web100m": {"n_users": 4000, "n_items": 3000},
}
TINY_TRAFFIC = {"batch": 64, "pool": 4, "trace_seconds": 1}


def tiny_root(dest: Path) -> Path:
    """A benchmark root at ``dest``: ``BENCHMARK.json`` and every file it
    names, the configurations and mixes cut by ``TINY``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "perfbench" / "metrics", dest / "perfbench" / "metrics")
    (dest / "perfbench" / "configs").mkdir(parents=True)
    (dest / "perfbench" / "traffic").mkdir(parents=True)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY.get(c["name"], {}))
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        name = f"perfbench/traffic/{w['traffic']}.json"
        mix = json.loads((ROOT / name).read_text())
        mix.update(TINY_TRAFFIC)
        (dest / name).write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
