"""chip_smoke.py rehearsed on the CPU at a small size.

The script's phases take the device and the sizes as arguments, so the
same code that runs on the card (artifacts in the JAX formats, the kernel
checks against the twin, the serve path with its output checks) runs here
through the plain twins. Only the CUDA launches and timings are the card's.
"""
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The training loops here run many tiny ops. With several test workers
    on one machine, torch's default pool of one spinning thread per core
    oversubscribes it (a 3 s rehearsal took 110 s); one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert (rec["d"], rec["d_func"]) == (24, 17)   # 16 + bias, padded to 8


def test_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=600,
                                 batch=400, n_requests=5, k=10)
    assert out["batch_users"] == 600 and out["requests"] == 5
    assert out["retrieval_score_abs_err"] <= 1e-3
    assert out["batch_vs_single_top_k_agreement"] == 1.0
    assert out["launches"] == {"window_mips": 0,   # the CPU runs the twins
                               "window_mips_qm": 0, "window_mips_i8": 0}


def test_artifacts_include_the_int8_index(small_artifacts):
    from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex

    paths, _ = small_artifacts
    index = JaxIndex.load(paths["index_i8_path"])
    assert (index.dtype, index.mode, index.quant_seed) == ("int8", "fused", 0)
    assert index.n_total == 5000 and index.has_bias
    assert index._embs.shape == (5120, 17)
    rows = np.load(paths["catalog_path"])
    assert rows.shape == (5000, 17) and rows.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(rows[:, :16], axis=1), 1.0,
                               rtol=1e-5)


def test_quantize_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    rec = chip_smoke.quantize_phase(paths, "cpu", 0, timer=_host_ms)
    assert rec["values_equal"] and rec["scales_equal"]
    assert rec["build_equals_saved_index"] and rec["build_scales_equal"]
    assert rec["max_abs_err"] == 0.0 and rec["launches"] == {"quantize_i8": 0}
    assert (rec["n"], rec["d"]) == (5000, 17)


def test_quantize_phase_fails_on_another_seed(small_artifacts):
    """The saved index was quantised with seed 0: the build quantizer at
    seed 1 does not reproduce it, and the phase says so."""
    paths, _ = small_artifacts
    with pytest.raises(AssertionError, match="build quantizer"):
        chip_smoke.quantize_phase(paths, "cpu", 1, timer=_host_ms)


def test_int8_kernel_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    (rec,) = chip_smoke.int8_kernel_phase(paths, "cpu", 0, qs=(64,), k=100,
                                          window=8, timer=_host_ms,
                                          min_recall=0.9, min_f32_recall=0.8)
    assert rec["window_max_equal"] and rec["window_arg_equal"]
    assert rec["topk_ids_equal"] and rec["topk_values_equal"]
    assert rec["recall_vs_int8_exact"] >= rec["bin_model_recall"] - 0.02
    assert (rec["d"], rec["d_func"]) == (32, 17)
    assert rec["dtype"] == "torch.int8"


def test_int8_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=600,
                                 batch=400, n_requests=5, k=10, dtype="int8")
    assert out["index_dtype"] == "int8" and out["batch_users"] == 600
    assert out["retrieval_score_abs_err"] <= 1e-3
    assert out["batch_vs_single_top_k_agreement"] == 1.0
    assert out["launches"] == {"window_mips": 0, "window_mips_qm": 0,
                               "window_mips_i8": 0}


def test_capacity_phase_on_the_twin():
    rec = chip_smoke.capacity_phase("cpu", 0, n_rows=50_000, dim=16, window=64,
                                    n_q=64, n_check=16, k=100, chunk=7000,
                                    block=1024, timer=_host_ms, min_recall=0.9)
    assert rec["window_max_equal"] and rec["window_arg_equal"]
    assert rec["corpus_bytes"] == 50_176 * 16 + 4 * 50_176
    assert rec["recall_vs_int8_exact"] >= rec["bin_model_recall"] - 0.02
    assert rec["queries_per_s"] > 0


def test_bpr_kernel_phase_on_the_twins():
    recs = chip_smoke.bpr_kernel_phase("cpu", 0, shapes=((64, 16), (50, 16)),
                                       timer=_host_ms)
    assert [(r["b"], r["d"]) for r in recs] == [(64, 16), (50, 16)]
    for r in recs:
        assert r["loss_rel_err"] == 0.0 and r["grad_max_abs_err"] == 0.0
        assert 0.6 < r["loss"] < 0.8          # ≈ ln 2 for random unit rows


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train phase at 600 users x 400 items, towers 16/32, batch 256,
    4 epochs (enough for retrieval to beat a random ranking clearly)."""
    tmp = tmp_path_factory.mktemp("train")
    data, view = chip_smoke.make_train_data(0, 600, 400, 40_000)
    model, rec = chip_smoke.train_phase(view, "cpu", 0, tmp, epochs=4, dim=16,
                                        hidden=32, batch=256)
    return data, view, model, rec, tmp


def test_train_phase_checks_pass(trained):
    data, view, model, rec, tmp = trained
    assert len(view) == int(len(data) * chip_smoke.TRAIN_SPLIT)
    assert rec["steps"] == 4 * (rec["positives"] // 256)
    assert rec["losses"][-1] < rec["losses"][0] < 0.7
    assert rec["launches"] == {"bpr_fwd": 0, "bpr_bwd": 0}   # twins on the CPU
    assert np.isfinite(rec["softmax_loss"])
    assert (tmp / "two_tower_bpr.npz").exists()


def test_index_phase_checks_pass(trained):
    data, view, model, _, tmp = trained
    rec = chip_smoke.index_phase(model, data, view, "cpu", 0, tmp, n_users=200)
    assert rec["users"] == 200 and rec["index_items"] == 400
    assert not rec["index_has_bias"]
    assert 0 < 1.2 * rec["random_recall@20"] < rec["recall@20"]


def test_train_phase_counts_every_launch(trained, monkeypatch):
    """A forward counted without its backward fails the launch check."""
    from recommendit_tpu_torch.ops import bpr

    _, view, _, _, tmp = trained
    twin = bpr.bpr_forward

    def counted(u, v):
        bpr.LAUNCHES["bpr_fwd"] += 1
        return twin(u, v)

    monkeypatch.setattr(bpr, "bpr_forward", counted)
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.train_phase(view, "cpu", 0, tmp, epochs=4, dim=16,
                               hidden=32, batch=256)


def test_qm_window_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    recs = chip_smoke.qm_window_phase(paths, "cpu", 0, qs=(16, 64), k=40,
                                      window=8, default_window=64,
                                      block=1024, timer=_host_ms)
    assert [(r["q"], r["window"]) for r in recs] == [(16, 8), (64, 8), (64, 64)]
    for rec in recs:
        assert rec["window_max_abs_err"] == 0.0
        assert rec["equals_items_major_transposed"]
        assert rec["id_overlap_vs_twin"] == 1.0
        assert (rec["d"], rec["d_func"]) == (24, 17)
    assert "kernel_ms" in recs[-1] and "kernel_ms" not in recs[0]


def test_fold_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    rec = chip_smoke.fold_phase(paths, "cpu", 0, n_q=32, k=50, block=1024,
                                reduction=16, timer=_host_ms, min_recall=0.9,
                                tie_cases=((301, 4, 3, 16, 4),))
    assert rec["max_abs_err"] == 0.0 and rec["ids_equal_share"] == 1.0
    assert rec["ties_equal"] == [True, True]
    assert (rec["n"], rec["d"], rec["n_cand"]) == (5000, 24, 5 * 64)
    assert rec["d_func"] == 17
    assert rec["recall_vs_exact"] >= rec["bin_model_recall"] - 0.05


def test_gather_phase_on_the_twin(small_artifacts):
    paths, _ = small_artifacts
    rec = chip_smoke.gather_phase(paths, "cpu", 0, shape=(40, 30), timer=_host_ms)
    assert rec["equal"] and all(rec["variants_equal"].values())
    assert rec["table"] == [5001, 64] and rec["launches"] == {"gather_rows": 0}
    assert 1200 * 256 < rec["bytes"] <= 2 * 1200 * 256 + 1200 * 8


def test_probe_phase_runs_every_variant():
    recs, launches = chip_smoke.probe_phase(
        "cpu", ("--n", "4096", "--d", "16", "--q", "8", "--k", "20",
                "--iters", "2"))
    assert [r["variant"] for r in recs] == ["window", "window_im",
                                            "window_im_int8", "fold"]
    assert all(r["ok_vals"] and r["ok_top1"] for r in recs)
    assert not any(launches.values())      # the twins on the CPU


def test_bounds():
    assert chip_smoke.bound(3.35e9) == pytest.approx((1.0, "bytes"))
    assert chip_smoke.bound(1.0, 989e9, "bf16") == pytest.approx((1.0, "operations"))
    # the function's 129 columns count, not the 136 the device rows are padded to
    rec = {"q": 1024, "n": 1_000_000, "d": 136, "d_func": 129, "window": 64}
    ms, by = chip_smoke.window_bound(rec, 2, 4, "bf16")
    assert by == "operations" and ms == pytest.approx(2 * 1024 * 1e6 * 129 / 989e9)


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
