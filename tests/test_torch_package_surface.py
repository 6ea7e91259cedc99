"""The rest of the package surface (ROADMAP A.12) against the JAX package's,
on the CPU:

* ``utils/profiling.py``: ``StageTimer`` and ``time_jitted`` on JAX's
  ``tests/test_utils.py`` cases, and ``device_trace`` writing a trace that
  holds the block's operators;
* ``utils/logging.get_logger``;
* ``data/native.py`` on ``native/fastparse.cpp`` (built from the repo's
  source at first use): equal to the port's pure numpy reader and to JAX's
  ``load_movielens`` on ``tests/fixtures/ml1m_golden``, JAX's malformed-line
  cases, ``None`` for a missing file;
* ``features/snapshot.py``'s native reader on ``native/feature_snapshot.cpp``
  equal to its numpy reader and to JAX's reader;
* the export lists of the ``__init__``s against JAX's, less
  ``download_movielens`` (not ported: a download) and with ``TwoTower``
  where JAX has ``TwoTowerModel``; ``RedisFeatureStore`` is the port's
  ``FeatureStore``, as in JAX.
"""
import ast
import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.utils.profiling import StageTimer, device_trace, time_jitted

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "ml1m_golden"
NOT_PORTED = {"download_movielens"}
RENAMED = {"TwoTowerModel": "TwoTower"}


# ------------------------------------------------------------------ #
# profiling and logging                                                #
# ------------------------------------------------------------------ #

def test_stage_timer_accumulates():
    st = StageTimer()
    with st.stage("a"):
        time.sleep(0.01)
    with st.stage("a"):
        time.sleep(0.01)
    with st.stage("b"):
        pass
    rep = st.report()
    assert rep["a"] >= 0.02 and "b" in rep


def test_time_jitted_returns_stats():
    out = time_jitted(lambda x: x * 2, torch.ones((4, 4)), iters=5, warmup=1)
    assert out["median_ms"] >= 0 and out["iters"] == 5
    assert set(out) == {"median_ms", "p10_ms", "p90_ms", "iters"}
    assert out["p10_ms"] <= out["median_ms"] <= out["p90_ms"]


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    with device_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_get_logger_is_jax_s():
    from recommendit_tpu.utils.logging import get_logger as jax_get_logger
    from recommendit_tpu_torch.utils import get_logger, setup_logging

    assert get_logger("recommendit.x") is logging.getLogger("recommendit.x")
    assert get_logger("recommendit.x") is jax_get_logger("recommendit.x")
    assert callable(setup_logging)


# ------------------------------------------------------------------ #
# native loaders                                                       #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def fastparse():
    from recommendit_tpu_torch.data import native

    assert native.available(), "g++ builds native/fastparse.cpp here"
    return native


def test_parse_int4_file_equals_the_readers(fastparse):
    from recommendit_tpu.data.movielens import load_movielens as jax_load
    from recommendit_tpu_torch.data.movielens import _read_ratings

    cols = fastparse.parse_int4_file(str(GOLDEN / "ratings.dat"))
    assert cols is not None and len(cols) == 4 and len(cols[0]) > 0
    np.testing.assert_array_equal(np.stack(cols, axis=1),
                                  _read_ratings(GOLDEN / "ratings.dat"))
    r = jax_load(str(GOLDEN)).ratings
    for col, name in zip(cols, ("user_id", "item_id", "rating", "timestamp")):
        want = r[name].to_numpy()
        if name == "timestamp":        # JAX's loader keeps datetimes
            want = want.astype("datetime64[s]").astype(np.int64)
        np.testing.assert_array_equal(col, want)
        assert col.dtype == np.int64


@pytest.mark.parametrize("text, want", [
    ("1::2::3::4\nbroken line\n5::6::7::8\n1::2\n", [[1, 5], [2, 6], [3, 7], [4, 8]]),
    ("1::2::3::4\n9::8::7::6", [[1, 9], [2, 8], [3, 7], [4, 6]]),
], ids=["malformed_lines_skipped", "no_trailing_newline"])
def test_parse_int4_file_jax_cases(fastparse, tmp_path, text, want):
    p = tmp_path / "r.dat"
    p.write_text(text)
    cols = fastparse.parse_int4_file(str(p))
    for col, w in zip(cols, want):
        np.testing.assert_array_equal(col, w)


def test_parse_int4_file_missing_is_none(fastparse, tmp_path):
    assert fastparse.parse_int4_file(str(tmp_path / "nope.dat")) is None


def _snapshot(tmp_path):
    from recommendit_tpu_torch.features.snapshot import write_snapshot

    rng = np.random.default_rng(0)
    uids = np.array([3, 1, 7, 11], np.int64)
    iids = np.array([10, 2, 30, 5, 8], np.int64)
    path = tmp_path / "f.fsnap"
    write_snapshot(str(path), uids, rng.random((4, 5)).astype(np.float32),
                   iids, rng.random((5, 6)).astype(np.float32),
                   ["avg_rating", "log_rating_count"] + ["genre_pref"] * 3,
                   ["avg_rating", "popularity_score"] + ["genre_vector"] * 4)
    return path, uids, iids


def test_snapshot_native_reader_equals_numpy_and_jax(tmp_path):
    from recommendit_tpu.features.snapshot import FeatureSnapshot as JaxSnapshot
    from recommendit_tpu_torch.features.snapshot import FeatureSnapshot

    path, uids, iids = _snapshot(tmp_path)
    nat = FeatureSnapshot(str(path))
    ref = FeatureSnapshot(str(path), prefer_native=False)
    jax_snap = JaxSnapshot(str(path))
    assert nat.native and not ref.native
    assert nat.n_users() == ref.n_users() == jax_snap.n_users() == 4
    assert nat.n_items() == ref.n_items() == jax_snap.n_items() == 5
    for u in [*uids.tolist(), 2, 99]:
        got, want = nat.user_row(u), ref.user_row(u)
        assert (got is None) == (want is None) == (jax_snap.user_row(u) is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, jax_snap.user_row(u))
            assert nat.user_dict(u) == ref.user_dict(u) == jax_snap.user_dict(u)
    ids = np.array([5, 99, 10, 8, -1, 30], np.int64)
    for a, b in ((nat.gather_items(ids, fill=-2.0), ref.gather_items(ids, fill=-2.0)),
                 (nat.gather_items(ids, fill=-2.0), jax_snap.gather_items(ids, fill=-2.0))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for i in iids.tolist():
        assert nat.item_dict(i) == ref.item_dict(i) == jax_snap.item_dict(i)
    nat.close()
    nat.close()
    ref.close()


# ------------------------------------------------------------------ #
# exports                                                              #
# ------------------------------------------------------------------ #

def _imported_names(path: Path):
    """The names an ``__init__.py`` binds by ``from … import``."""
    tree = ast.parse(path.read_text())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names
                  if not node.module.startswith(("json", "pathlib", "typing")))


def _port_names(jax_names):
    return sorted(RENAMED.get(n, n) for n in jax_names if n not in NOT_PORTED)


@pytest.mark.parametrize("sub", ["features", "data", "utils", "models"])
def test_subpackage_exports_pin_jax_s(sub):
    import importlib

    want = _port_names(_imported_names(ROOT / "recommendit_tpu" / sub / "__init__.py"))
    if sub == "models":
        want = sorted(want + ["load_ranker"])     # a function, as in JAX
    mod = importlib.import_module(f"recommendit_tpu_torch.{sub}")
    missing = [n for n in want if not hasattr(mod, n)]
    assert not missing, missing
    if sub == "features":
        assert mod.RedisFeatureStore is mod.FeatureStore
    ported = _imported_names(ROOT / "recommendit_tpu_torch" / sub / "__init__.py")
    if sub == "models":
        ported = sorted(set(ported) - {"DEFAULT_DEVICE", "Union"} | {"load_ranker"})
    assert ported == want


def test_top_level_exports_pin_jax_s():
    import recommendit_tpu
    import recommendit_tpu_torch
    from recommendit_tpu_torch.config import Settings, settings

    tree = ast.parse((ROOT / "recommendit_tpu" / "__init__.py").read_text())
    lazy = next(node for node in ast.walk(tree) if isinstance(node, ast.Dict))
    jax_lazy = [k.value for k in lazy.keys]
    assert list(recommendit_tpu_torch.EXPORTS) == [RENAMED.get(n, n) for n in jax_lazy]
    for name in recommendit_tpu_torch.EXPORTS:
        assert getattr(recommendit_tpu_torch, name) is not None
    assert recommendit_tpu_torch.Settings is Settings
    assert recommendit_tpu_torch.settings is settings
    assert recommendit_tpu_torch.__version__ == recommendit_tpu.__version__
    with pytest.raises(AttributeError):
        recommendit_tpu_torch.TwoTowerModel


def test_jax_aliases_are_ported():
    """JAX's three aliases of the reference's names, bound where JAX binds
    them: ``LightGBMRanker``, ``batched_lambdarank_loss`` and
    ``MIPSIndex.build_ivf_index``."""
    from recommendit_tpu.models import ranker as jax_ranker
    from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
    from recommendit_tpu_torch.models import MIPSIndex, ranker

    assert jax_ranker.LightGBMRanker is jax_ranker.LambdaRankScorer
    assert ranker.LightGBMRanker is ranker.LambdaRankScorer
    assert JaxIndex.build_ivf_index is JaxIndex.build
    assert MIPSIndex.build_ivf_index is MIPSIndex.build
    params = ranker.init_mlp(torch.Generator().manual_seed(0), 6, (8, 4))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 6, generator=gen)
    gains = torch.randint(0, 3, (3, 5), generator=gen).float()
    mask = torch.ones(3, 5)
    assert torch.equal(ranker.batched_lambdarank_loss(params, x, gains, mask),
                       ranker.batched_group_loss(params, x, gains, mask, "lambdarank"))
