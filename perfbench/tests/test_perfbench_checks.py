"""The check that decides ``correct`` passes the program and fails its
control and each fault a cell can have: driven here on the CPU at a small
size (the harness's look for a card skipped), and on the card at the
cells' own sizes by the ``cuda`` tests."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import control, judge
from perfbench.run import run_cell
from perfbench.spec import load_cell
from perfbench.tests.tiny import ROOT, tiny_root

SEED = 2**31 + 12345
SERVE = ("serve1m-b4096", "serve1m-exact-b1024")
TRAIN = ("web100m-rank-train", "web100m-train-4chip")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench") / "b")


def _run(root, workload, trace=False):
    return run_cell(load_cell(workload, root), SEED, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_program_is_correct(root, workload):
    r = _run(root, workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_traced_run_is_correct_and_reads_the_trace(root):
    r = _run(root, "serve1m-b4096", trace=True)
    assert r["correct"], r["checks"]
    assert "breakdown" in r and r["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", SERVE)
def test_serve_control_fails(root, workload):
    cell = load_cell(workload, root)
    assert not judge.passed(judge.checks(control.serve_control(cell, SEED, "cpu"),
                                         cell.config["checks"]))


@pytest.mark.parametrize("workload, what", [
    ("web100m-rank-train", "control"), ("web100m-rank-train", "half"),
    ("web100m-train-4chip", "control"), ("web100m-train-4chip", "half"),
    ("web100m-train-4chip", "solo")])
def test_train_control_and_faults_fail(root, workload, what):
    """The control; half of the batch; the exchange between ranks left out
    (four gloo ranks on the CPU)."""
    cell = load_cell(workload, root)
    nums = control.train_control(cell, SEED, "cpu", what)
    assert not judge.passed(judge.checks(nums, cell.config["checks"])), nums


def _serve_fault(monkeypatch, kind):
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    orig = RecommendationPipeline.serve_batch
    last = {}

    def serve_batch(self, user_ids):
        if kind == "half":            # half of the batch left out
            n = len(user_ids)
            out = orig(self, user_ids[: max(1, n // 2)])
            return tuple(torch.cat([t, t, t])[:n] for t in out)
        out = orig(self, user_ids)
        if kind == "altered":         # an answer altered where it is produced
            ids = out[0].clone()
            ids[:, [0, 1]] = ids[:, [1, 0]]
            return (ids,) + tuple(out[1:])
        if kind == "stale":           # the last call's answers returned again
            prev = last.get("out", out)
            last["out"] = out
            return prev
        raise ValueError(kind)

    monkeypatch.setattr(RecommendationPipeline, "serve_batch", serve_batch)


@pytest.mark.parametrize("kind", ["half", "altered", "stale"])
def test_serve_faults_fail(root, monkeypatch, kind):
    _serve_fault(monkeypatch, kind)
    r = _run(root, "serve1m-b4096")
    assert not r["correct"], r["checks"]


def _train_fault(monkeypatch, kind):
    from recommendit_tpu_torch.parallel import mesh, train

    if kind == "unchanged":           # a step that leaves the state as it was
        monkeypatch.setattr(mesh.ShardedOptState, "apply_", lambda self, grads: None)
        return
    make = train.make_sharded_train_step

    def make_half(*a, **k):           # half of the batch left out
        step = make(*a, **k)

        def half_step(params, state, batch, rng=None):
            return step(params, state, tuple(t[: t.shape[0] // 2] for t in batch), rng)
        return half_step

    monkeypatch.setattr(train, "make_sharded_train_step", make_half)


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_train_faults_fail(root, monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    r = _run(root, "web100m-rank-train")
    assert not r["correct"], r["checks"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_control_fails_at_the_cells_size(cuda, workload):
    """The control on the card at the cell's own size, on three seeds."""
    cell = load_cell(workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    for seed in (SEED, SEED + 1, SEED + 2):
        if cell.config["system"] == "serve":
            nums = control.serve_control(cell, seed, cuda)
        else:
            nums = control.train_control(cell, seed, cuda, "control")
        assert not judge.passed(judge.checks(nums, cell.config["checks"])), nums
