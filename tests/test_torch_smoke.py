"""chip_smoke.py rehearsed on the CPU at a small size.

The script's phases take the device and the sizes as arguments, so the
same code that runs on the card (artifacts in the JAX formats, the kernel
checks against the twin, the serve path with its output checks) runs here
through the plain twins. Only the CUDA launches and timings are the card's.
"""
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke


def _host_ms(fn, reps, warm=1):
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


@pytest.fixture(scope="module")
def small_artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chip_smoke")
    return chip_smoke.make_artifacts(
        tmp, seed=0, device="cpu", n_users=300, n_items=5000, dim=16,
        hidden=32, n_ratings=20_000, block_size=1024)


def test_artifacts_load_in_the_jax_formats(small_artifacts):
    from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
    from recommendit_tpu.models.two_tower import TwoTowerModel

    paths, data = small_artifacts
    model = TwoTowerModel.load(paths["model_path"])
    index = JaxIndex.load(paths["index_path"])
    assert (model.n_users, model.n_items, model.embed_dim) == (300, 5000, 16)
    assert index.n_total == 5000 and index.has_bias
    assert index.mode == "fused" and index.dtype == "bfloat16"
    assert data.user_id.shape == data.item_id.shape == (20_000,)


def test_kernel_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    recs = chip_smoke.kernel_phase(paths, "cpu", 0, qs=(64,), k=100,
                                   window=8, timer=_host_ms, min_recall=0.9)
    (rec,) = recs
    assert rec["window_max_abs_err"] == 0.0
    assert rec["id_overlap_vs_twin"] == 1.0
    assert rec["recall_vs_exact"] >= rec["bin_model_recall"] - 0.02
    assert rec["d"] == 24


def test_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=600,
                                 batch=400, n_requests=5, k=10)
    assert out["batch_users"] == 600 and out["requests"] == 5
    assert out["retrieval_score_abs_err"] <= 1e-3
    assert out["batch_vs_single_top_k_agreement"] == 1.0
    assert out["launches"] == {"window_mips": 0}   # the CPU runs the twin


def test_overlap_counts_shared_ids():
    a = torch.tensor([[1, 2, 3], [4, 5, 6]])
    b = torch.tensor([[3, 2, 9], [6, 7, 8]])
    assert chip_smoke._overlap(a, b) == pytest.approx(0.5)


def test_exits_nonzero_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
