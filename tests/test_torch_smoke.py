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
        hidden=32, n_ratings=20_000, block_size=1024, gbdt_trees=20)


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
    assert rec["tc_route"]                 # bf16 at "default" on the card
    assert rec["gemm_only_ms"] > 0 and rec["bound_share"] > 0


def test_router_phase_times_both_routes(small_artifacts):
    paths, _ = small_artifacts
    recs, crossover = chip_smoke.router_phase(paths, "cpu", 0, qs=(8, 64),
                                              k=40, block=1024, timer=_host_ms)
    assert [r["q"] for r in recs] == [8, 64]
    for r in recs:
        assert r["scan_ms"] > 0 and r["kernel_ms"] > 0
        assert r["router_takes"] == "kernel" and r["window"] == 8
    assert crossover in (None, 8, 64)


def test_ptxas_summary_reads_each_kernel():
    log = """\
ptxas info    : Compiling entry function '_ZN2tc16window_tc_kernelILi6ELb0EEEv14CUtensorMap_stS1_PfPiNS_5ShapeE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 80 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__2bd83553_14_window_mips_cu_e380ed1d18window_mips_kernelI13__nv_bfloat16Lb1EEEvPKfPKT_PfPiiiiiix' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 20480 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119bpr_bwd_tile_kernelEPKfS1_iiPfS2_S2_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tc16window_tc_kernelILi0ELb0ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_PfPiNS_5ShapeE' for 'sm_90a'
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 144 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__1f2e3d4c_17_window_mips_i8_cu_a1b2c3d421window_mips_i8_kernelEPKaS1_PKfPfPiiiiiix' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 57 registers, used 1 barriers, 18432 bytes smem
"""
    assert chip_smoke.ptxas_summary(log) == {
        "window_tc_kernel<6,0>": {"spill_stores": 0, "spill_loads": 0,
                                  "registers": 168, "static_smem": 80},
        "window_mips_kernel<bf16,1>": {"spill_stores": 4, "spill_loads": 12,
                                       "registers": 64, "static_smem": 20480},
        "bpr_bwd_tile_kernel": {"spill_stores": 0, "spill_loads": 0,
                                "registers": 122, "static_smem": 0},
        "window_tc_kernel<0,0,1>": {"spill_stores": 24, "spill_loads": 24,
                                    "registers": 168, "static_smem": 144},
        "window_mips_i8_kernel": {"spill_stores": 0, "spill_loads": 0,
                                  "registers": 57, "static_smem": 18432},
    }


@pytest.mark.parametrize("name,short,group", [
    ("void tc::window_tc_kernel<6, false>(CUtensorMap_st, CUtensorMap_st, "
     "float*, int*, tc::Shape)", "tc::window_tc_kernel", "window kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_"
     "nocast<at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&)",
     "elementwise_kernel:add", "elementwise"),
    ("void at::native::mbtopk::gatherTopK<float, unsigned int, 2>(x)",
     "mbtopk::gatherTopK", "top-k"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_cublas",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_cublas", "cuBLAS GEMMs"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::"
     "(anonymous namespace)::OpaqueType<4u>, unsigned int, 3, 64, 64>(x)",
     "CatArrayBatchedCopy", "cat"),
])
def test_profile_names_and_groups(name, short, group):
    assert chip_smoke._short_kernel_name(name) == short
    assert chip_smoke._kernel_group(name) == group


def test_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out, pipe = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=600,
                                       batch=400, n_requests=5, k=10)
    assert pipe._loaded and pipe.index.dtype == "bfloat16"
    assert out["batch_users"] == 600 and out["requests"] == 5
    assert out["retrieval_score_abs_err"] <= 1e-3
    assert out["batch_vs_single_top_k_agreement"] == 1.0
    assert out["launches"] == {"window_mips": 0,   # the CPU runs the twins
                               "window_mips_qm": 0, "window_mips_i8": 0}
    assert out["search_device"] == {
        "queries": 400, "k": chip_smoke.TOP_K_CANDIDATES, "index_dtype": "bfloat16",
        "calls": 2, "launches": 0, "ids_equal": True, "max_abs_err": 0.0,
        "repeat_bit_identical": True}


def test_search_device_launches_are_checked(small_artifacts):
    """The search_device count is held to one launch a call on the card: a
    run that launched nothing (here, the twins) fails that check."""
    paths, data = small_artifacts
    pipe = chip_smoke.load_pipeline(paths, data, "cpu", "int8")
    q = pipe.model.user_tower(torch.arange(400) % pipe.model.n_users + 1)
    with chip_smoke._WindowLaunches("window_mips_i8", ("search_device",)) as window:
        pipe.index.search_device(q, 100)
    assert window.calls == [("search_device", 0, 400, "fused")]
    with pytest.raises(AssertionError, match="launched window_mips_i8 0 times, expected 1"):
        window.check("int8", 0, on_card=True)
    assert window.check("int8", 0, on_card=False) == {"search_device": 0}


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
    (rec,), wide = chip_smoke.int8_kernel_phase(
        paths, "cpu", 0, qs=(64,), k=100, window=8, timer=_host_ms,
        min_recall=0.9, min_f32_recall=0.8, wide_rows=3000)
    assert rec["window_max_equal"] and rec["window_arg_equal"]
    assert rec["topk_ids_equal"] and rec["topk_values_equal"]
    assert rec["recall_vs_int8_exact"] >= rec["bin_model_recall"] - 0.02
    assert (rec["d"], rec["d_func"]) == (32, 17)
    assert rec["dtype"] == "torch.int8"
    # the body is the one launched: the twin on the CPU launches none
    assert rec["body"] is None and rec["tc_route"] is False
    assert rec["int8_gemm_only_ms"] > 0
    assert rec["bound_share"] > 0
    assert "dp4a_ms" not in rec                 # the C entries: on the card only
    assert wide == {"q": 64, "n": 3000, "d": 400, "window": 8,
                    "body": None, "equal": True}


def test_int8_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out, pipe = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=600,
                                       batch=400, n_requests=5, k=10,
                                       dtype="int8")
    assert pipe._loaded and pipe.index.dtype == "int8"
    assert out["index_dtype"] == "int8" and out["batch_users"] == 600
    assert out["retrieval_score_abs_err"] <= 1e-3
    assert out["batch_vs_single_top_k_agreement"] == 1.0
    assert out["launches"] == {"window_mips": 0, "window_mips_qm": 0,
                               "window_mips_i8": 0}
    sd = out["search_device"]
    assert sd["index_dtype"] == "int8" and sd["ids_equal"] and sd["launches"] == 0
    assert sd["max_abs_err"] == 0.0 and sd["repeat_bit_identical"]


def test_capacity_phase_on_the_twin():
    rec = chip_smoke.capacity_phase("cpu", 0, n_rows=50_000, dim=16, window=64,
                                    n_q=64, n_check=16, k=100, chunk=7000,
                                    block=1024, timer=_host_ms, min_recall=0.9)
    assert rec["window_max_equal"] and rec["window_arg_equal"]
    assert rec["body"] is None                  # the twin launched no body
    assert rec["corpus_bytes"] == 50_176 * 16 + 4 * 50_176
    assert rec["recall_vs_int8_exact"] >= rec["bin_model_recall"] - 0.02
    assert rec["queries_per_s"] > 0


TINY_DRIVERS = {
    "recall_10m": ("--n", "200000", "--d", "16", "--k", "10", "--queries", "6"),
    "mips_ab": ("--n", "8192", "--d", "16", "--k", "10", "--qs", "4", "--iters", "1",
                "--recall-queries", "4"),
    "fused_decomp": ("--qs", "4", "--k", "10", "--d", "16", "--iters", "1",
                     "--n-dec", "10000", "--n-bin", "8192"),
    "recall_curve": ("--n-items", "3000", "--dim", "16", "--k", "10", "--batch", "8",
                     "--block", "1024", "--iters", "1"),
    "bound_turf": ("--n", "256", "--dims", "32", "64", "--q", "8", "--k", "10",
                   "--m", "64", "--iters", "1"),
    "tail_probe": ("--q", "4", "--k", "10", "--n-cand", "200", "--iters", "1"),
}


def test_drivers_phase_on_the_twins(tmp_path):
    """The drivers phase through the twins: every report written under the
    workdir, the twin checks at zero error, no launch on the CPU."""
    out = chip_smoke.drivers_phase(
        "cpu", 0, tmp_path, "cpu", args=TINY_DRIVERS, timer=_host_ms,
        capacity=dict(n_rows=20_000, dim=16, n_q=8, n_check=6, k=10, chunk=7000,
                      block=1024, iters=1, min_recall=0.5))
    names = ["recall_10m", "capacity_30m", "mips_ab", "fused_decomp", "recall_curve",
             "bound_turf", "tail_probe"]
    assert [n for n in out if n in names] == names
    for name in names:
        assert (tmp_path / "drivers" / f"{name}.json").exists(), name
    r10 = out["recall_10m"]
    assert r10["window"] == 512 and r10["n_pad"] == 200_704 and r10["body"] is None
    assert r10["window_max_abs_err"] == 0.0 and r10["args_equal_share"] == 1.0
    assert r10["recall_at_500"]["mean"] >= r10["bin_model_recall"] - 0.01
    for body in ("f32", "bf16"):
        rec = out["mips_ab"][body]
        assert rec["window_max_abs_err"] == 0.0 and rec["args_equal_share"] == 1.0
        assert rec["check_body"] is None                  # the twin, on the CPU
    fd = out["fused_decomp"]
    assert (fd["window"], fd["n_valid"], fd["check_q"]) == (32, 10_000, 8)
    assert fd["window_max_abs_err"] == 0.0 and fd["args_equal_share"] == 1.0
    assert [r["variant"] for r in fd["report"]["rows"]][:2] == [
        "dec1M_w64_masked", "dec1M_w32_masked"]
    assert out["capacity_30m"]["window"] == 512
    assert out["capacity_30m"]["script"]["window"] == 512
    assert len(out["timer_chain"]["round_ms"]) == 4 and out["timer_chain"]["best_ms"] > 0
    assert out["launches"] == {
        "window_mips": {"recall_10m": 0, "mips_ab": 0, "fused_decomp": 0},
        "window_mips_i8": {"capacity_30m": 0}}


def test_window_agreement_reads_ties_and_the_masked_tail():
    """Positions that differ from the twin's count as ties only where the
    twin's score at the kernel's position is its maximum within the
    rounding; a masked window's position scores -3e38."""
    from recommendit_tpu_torch.ops import mips_window as mw

    items = torch.zeros((16, 4))
    items[1] = items[2] = torch.tensor([1.0, 0, 0, 0])   # a tie in window 0
    items[5] = torch.tensor([0.5, 0, 0, 0])
    q = torch.tensor([[1.0, 0, 0, 0]])
    rv, ra = mw.window_candidates_ref(q, items, 4, 10, "highest")
    ka = ra.clone()
    ka[0, 0] = 2                       # the other member of the tie
    rec = chip_smoke.window_agreement(q, items, rv, ka, rv, ra, 4, 10, "highest")
    assert rec["args_tie_gap"] == 0.0 and rec["args_equal_share"] == 0.75
    ka[0, 0], ka[3, 0] = 3, 1          # a zero row; a row of the masked window
    rec = chip_smoke.window_agreement(q, items, rv, ka, rv, ra, 4, 10, "highest")
    assert rec["args_tie_gap"] == 1.0
    ka[0, 0] = ra[0, 0]
    rec = chip_smoke.window_agreement(q, items, rv, ka, rv, ra, 4, 10, "highest")
    assert rec["args_tie_gap"] == 0.0


def test_bpr_kernel_phase_on_the_twins():
    recs = chip_smoke.bpr_kernel_phase("cpu", 0, shapes=((64, 16), (50, 16)),
                                       timer=_host_ms)
    assert [(r["b"], r["d"]) for r in recs] == [(64, 16), (50, 16)]
    for r in recs:
        assert r["loss_rel_err"] == 0.0 and r["grad_max_abs_err"] == 0.0
        assert 0.6 < r["loss"] < 0.8          # ≈ ln 2 for random unit rows
        assert r["repeat_bit_identical"] and r["gemm_only_ms"] > 0
        assert r["bound_fwd_ms"] > 0 and r["bound_bwd_3xtf32_ms"] > 0
        # TwoTower.in_batch_bpr_loss is the twin on the CPU: no launch
        assert r["two_tower"] == {"launches": {"bpr_fwd": 0, "bpr_bwd": 0},
                                  "loss_rel_err": 0.0, "du_err": 0.0, "dv_err": 0.0}


def test_bpr_bounds():
    """f32 products at 67 TFLOP/s; 3xTF32 three times as many at 495."""
    b = chip_smoke.bpr_bounds(1024, 64)
    assert b["fwd"] == pytest.approx((2 * 1024 ** 2 * 64 / 67e9, "operations"))
    assert b["bwd"] == pytest.approx((6 * 1024 ** 2 * 64 / 67e9, "operations"))
    assert b["bwd_3xtf32"] == pytest.approx((18 * 1024 ** 2 * 64 / 495e9,
                                             "operations"))


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


def test_profile_view_fills_the_steps(trained):
    _, view, _, _, _ = trained
    small = chip_smoke.profile_view(view, 20, 256)
    assert int((small.rating >= 4).sum()) // 256 == 20
    assert small.n_users == view.n_users and small.n_items == view.n_items


@pytest.mark.parametrize("name,group", [
    ("bpr_bwd_tile_kernel(float const*, float const*, int, int, float*, float*, "
     "float*)", "BPR kernels"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<x>(y)",
     "clipping and optimizer"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "GEMMs"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid>(x)",
     "elementwise"),
    ("void at::native::indexing_backward_kernel<float, 4>(x)",
     "gathers and index backward"),
])
def test_train_profile_groups(name, group):
    assert chip_smoke._train_kernel_group(name) == group


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
                                tie_cases=((301, 4, 3, 16, 4),), f64_q=8,
                                lo_case=(3000, 136, 16))
    assert rec["max_abs_err"] == 0.0 and rec["ids_equal_share"] == 1.0
    # the f32 twin is f32-grade; the control without the third piece is not
    lo = rec["lo_case"]
    assert rec["f64_q"] == 8 and (lo["n"], lo["d"], lo["q"]) == (3000, 136, 16)
    assert max(rec["f64_err"], lo["f64_err"]) <= chip_smoke.FOLD_F64_LIMIT / 2
    assert lo["two_piece_f64_err"] > 2 * chip_smoke.FOLD_F64_LIMIT
    assert rec["two_piece_f64_err"] > rec["f64_err"] and lo["body"] is None
    assert rec["ties_equal"] == [True, True]
    assert (rec["n"], rec["d"], rec["n_cand"]) == (5000, 24, 5 * 64)
    assert rec["d_func"] == 17
    assert rec["recall_vs_exact"] >= rec["bin_model_recall"] - 0.05
    # the twins on the CPU: no body, and the split is its own twin
    assert rec["body"] is None and not rec["tc_route"]
    assert rec["jax_reduction"] == 32 and rec["jax_reduction_body"] is None
    assert rec["split_equal"] and rec["split_max_abs_err"] == 0.0
    assert "cuda_cores_ms" not in rec and "ptxas" not in rec
    assert rec["bound_ms"] == chip_smoke.fold_bounds(rec)[0]


def test_fold_f64_err_reads_each_score_over_its_terms():
    """0 for the f64 scores themselves; a value moved by 1e-5·Σ|q_k·x_k|
    reads 1e-5; bins of pad rows must hold the pad score exactly."""
    from recommendit_tpu_torch.ops import mips_fold as mf

    g = torch.Generator().manual_seed(0)
    q = torch.randn(5, 8, generator=g)
    items = torch.randn(2 * 16 + 1, 8, generator=g).to(torch.bfloat16)
    vals, ids = mf.fold_candidates_ref(q, items, 16, 4)
    real = ids < items.shape[0]
    terms = q.double()[:, None, :] * items[ids.long().clamp(max=32)].double()
    exact = torch.where(real, terms.sum(-1), vals.double())
    assert chip_smoke.fold_f64_err(q, items, exact, ids) == 0.0
    moved = exact.clone()
    moved[2, 1] += 1e-5 * terms[2, 1].abs().sum()
    assert chip_smoke.fold_f64_err(q, items, moved, ids) == pytest.approx(1e-5)
    assert not bool(real.all())
    moved[~real] = 0.0
    with pytest.raises(AssertionError, match="pad score"):
        chip_smoke.fold_f64_err(q, items, moved, ids)


def test_fold_bounds():
    """Three bf16 passes at the bf16 peak for f32-grade scores on the
    tensor cores, and the f32 operations at the f32 rate beside them; D is
    the function's width."""
    rec = {"q": 1024, "n": 1_000_000, "d": 136, "d_func": 129,
           "n_cand": 489 * 32}
    ms, by, f32_ms = chip_smoke.fold_bounds(rec)
    assert by == "operations"
    assert ms == pytest.approx(3 * 2 * 1024 * 1e6 * 129 / 989e9)
    assert f32_ms == pytest.approx(2 * 1024 * 1e6 * 129 / 67e9)
    assert ms < f32_ms / 4


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


@pytest.mark.parametrize("n,d,window,want", [
    (1_000_000, 129, 64, 2 * 1024 * 1e6 * 129 / 1979e9),      # int8 serve
    (30_000_000, 128, 512, 2 * 1024 * 30e6 * 128 / 1979e9),   # capacity
])
def test_int8_window_bound(n, d, window, want):
    """The int8 kernel's bound at Q=1024: its int8 operations at the int8
    peak, above the bytes of the corpus and its scales."""
    rec = {"q": 1024, "n": n, "d": d + (-d % 16), "d_func": d, "window": window}
    ms, by = chip_smoke.window_bound(rec, 1, 1, "int8", scales=True)
    assert by == "operations" and ms == pytest.approx(want)


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


def test_http_phase_checks_pass(small_artifacts):
    """The HTTP phase at a small size: the bf16 and int8 pipelines behind
    the port's app, micro-batching in buckets of 8 and 32 with a 200 ms
    wait, closed-loop clients at 1, 8 and 24 in flight; every list equal to
    its direct bucket's, a dispatch of more than 8 requests into the 32
    bucket, no popularity answer, the extra routes."""
    paths, data = small_artifacts
    pipes = [chip_smoke.load_pipeline(paths, data, "cpu", dtype)
             for dtype in ("bfloat16", "int8")]
    out = chip_smoke.http_phase(*pipes, "cpu", levels=((1, 4), (8, 16), (24, 48)),
                                k=10, max_batch=32, wait_ms=200.0)
    for label, n_levels in (("bf16", 3), ("int8", 1)):
        rec = out[label]
        assert [lv["requests"] for lv in rec["levels"]] == [4, 16, 48][-n_levels:]
        assert all(lv["lists_checked"] == lv["requests"] for lv in rec["levels"])
        assert rec["big_bucket_dispatches"] >= 1 and rec["warm_on_dispatch_thread"]
        assert rec["levels"][-1]["max_batch_size"] > 8
        assert all(set(lv["launches"].values()) == {0} for lv in rec["levels"])
    from recommendit_tpu_torch.features import store

    assert out["feature_store"] == {
        "backend": "redis" if any(p.feature_store.is_redis_available for p in pipes)
        else "in-memory", "codec": "msgpack" if store.MSGPACK_AVAILABLE else "json",
        "redis_package": store.REDIS_AVAILABLE, "msgpack_package": store.MSGPACK_AVAILABLE}
    assert out["bf16"]["feature_update_user"] >= 1
    assert out["bf16"]["batch_route_users"] == 100
    assert all(p._batcher._thread.is_alive() is False for p in pipes)


def test_check_list_ties_and_differences():
    chip_smoke.check_list([3, 1, 2], [0.9, 0.5, 0.5 + 5e-5], [3, 2, 1],
                          [0.9, 0.5, 0.5])
    inf = float("-inf")
    chip_smoke.check_list([4, 7, 9], [0.1, inf, inf], [4, 9, 7], [0.1, inf, inf])
    with pytest.raises(AssertionError, match="ids differ"):
        chip_smoke.check_list([1, 2], [0.9, 0.5], [2, 1], [0.9, 0.5])
    with pytest.raises(AssertionError, match="scores differ"):
        chip_smoke.check_list([1, 2], [0.9, 0.5], [1, 2], [0.9, 0.4])


# --- the GBDT phases -------------------------------------------------------- #

def test_random_gbdt_loads_in_jax(small_artifacts):
    """``write_random_gbdt`` writes JAX's format: JAX's booster reads it and
    predicts as the port's; full trees of depth 6 over the 52 columns."""
    from recommendit_tpu.models.gbdt import HistGBDTRanker as JaxGBDT
    from recommendit_tpu_torch.models import load_ranker

    paths, _ = small_artifacts
    jr = JaxGBDT.load(paths["gbdt_path"])
    tr = load_ranker(paths["gbdt_path"], device="cpu")
    assert len(jr.trees) == 20 and jr.max_depth == 6 and jr.n_bins == 64
    assert jr.feature_names[-2:] == ["retrieval_score", "retrieval_rank"]
    assert jr.bin_edges.shape == (52, 63)
    assert all(int((t.feature >= 0).sum()) == 63 for t in jr.trees)
    x = np.random.default_rng(1).normal(size=(300, 52)).astype(np.float32)
    np.testing.assert_array_equal(tr.predict(x), jr.predict(x))


def test_gbdt_serve_phase_checks_pass(small_artifacts):
    paths, data = small_artifacts
    out, pipe = chip_smoke.gbdt_serve_phase(paths, data, "cpu", n_batch_users=400,
                                            batch=200, n_requests=5, k=10, workers=1)
    assert pipe.ranker.model_info()["model_type"] == "hist-gbdt-lambdarank"
    assert out["users_checked"] == 400 and out["requests"] == 5
    assert out["raw_score_max_abs_err"] <= 1e-5
    assert out["launches"] == {"window_mips": 0,   # the CPU runs the twins
                               "window_mips_qm": 0, "window_mips_i8": 0}


def test_host_predict_in_processes_equals_one_call(small_artifacts):
    from recommendit_tpu_torch.models import load_ranker

    paths, _ = small_artifacts
    x = np.random.default_rng(2).normal(size=(120, 52)).astype(np.float32)
    want = load_ranker(paths["gbdt_path"], device="cpu").predict(x)
    np.testing.assert_array_equal(chip_smoke.host_predict(paths["gbdt_path"], x, 2), want)


@pytest.fixture(scope="module")
def gbdt_pipeline(tmp_path_factory):
    """The pipeline phase at 600 users x 400 items, then the GBDT pipeline
    phase on its directories (6 trees), the booster forced onto its device
    backend, which ``auto`` takes only on a GPU."""
    from recommendit_tpu_torch.models import HistGBDTRanker

    tmp = tmp_path_factory.mktemp("gbdt_pipeline")
    data, _ = chip_smoke.make_train_data(0, 600, 400, 40_000)
    small = dict(epochs=4, dim=16, hidden=32, batch=256)
    mlp = chip_smoke.pipeline_phase(data, "cpu", 0, tmp, "cpu", **small,
                                    ranker_cfg=dict(RANKER_EPOCHS=3,
                                                    RANKER_HIDDEN_DIMS=(16, 8)))
    real = HistGBDTRanker.__init__

    def on_device_backend(self, *args, **kwargs):
        real(self, *args, **dict(kwargs, backend="device"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(HistGBDTRanker, "__init__", on_device_backend)
        rec = chip_smoke.gbdt_pipeline_phase(data, "cpu", 0, tmp, "cpu", mlp, **small,
                                             ranker_cfg=dict(GBDT_N_ESTIMATORS=6))
    return mlp, rec


def test_gbdt_pipeline_phase_checks_pass(gbdt_pipeline):
    mlp, rec = gbdt_pipeline
    assert rec["backend"] == "device" and rec["trees"] >= rec["best_iteration"] >= 1
    assert rec["tower_steps"] == mlp["tower_steps"][1:]
    assert rec["bpr_launches"] == {"bpr_fwd": 0, "bpr_bwd": 0}   # twins on the CPU
    assert rec["holdout"]["ndcg@10"] > rec["random_ndcg@10"]
    assert rec["host_device_max_abs_err"] <= 1e-5
    first = rec["first_tree"]
    assert first["splits_equal_cpu"] and first["repeat_levels_equal"]
    assert first["training_tree_equals_repeat"]
    assert set(rec["rows"]) == {"gbdt_full", "mlp_full", "popularity", "retrieval_only"}
    assert rec["rows"]["mlp_full"] == mlp["reports"]["exact_float32"]["rows"]["full"]
    assert rec["grower_ms_per_tree"] > 0 and len(rec["valid_ndcg@10"]) == rec["rounds"]


def _small_grow(seed=0, n=4000, n_feat=5, n_bins=16, depth=3):
    from recommendit_tpu_torch.models import gbdt

    rng = np.random.default_rng(seed)
    inputs = (torch.as_tensor(rng.integers(0, n_bins, (n_feat, n)).astype(np.uint8)),
              torch.as_tensor(rng.normal(size=n).astype(np.float32)),
              torch.as_tensor(rng.random(n).astype(np.float32)),
              torch.ones(n), torch.ones(n_feat, dtype=torch.bool))
    args = (n_feat, n_bins, depth, 20, 0.1)
    levels, _ = gbdt._make_grow_tree_device(*args)(*inputs)
    return inputs, args, chip_smoke._levels_np(levels)


def test_split_gap_on_equal_trees():
    inputs, args, levels = _small_grow()
    assert chip_smoke._split_gap(inputs, args, levels, levels) == (None, [])


def test_split_gap_flags_a_split_no_rounding_explains():
    """A node given another threshold than the best split is no near-tie:
    its exact gain falls short by far more than the f32 bound."""
    inputs, args, levels = _small_grow(1)
    other = [{k: v.copy() for k, v in lv.items()} for lv in levels]
    pos = int(np.flatnonzero(other[1]["do_split"])[0])
    other[1]["best_b"][pos] = (other[1]["best_b"][pos] + 7) % 15
    depth, gaps = chip_smoke._split_gap(inputs, args, other, levels)
    assert depth == 1 and [g["node"] for g in gaps] == [pos]
    assert not gaps[0]["within"] and gaps[0]["gap"] > 10 * gaps[0]["bound"] > 0
    assert gaps[0]["exact_cpu"] > gaps[0]["exact_card"]


def test_verified_phase_checks_pass(small_artifacts, monkeypatch):
    """The verified phase on the CPU: both certified methods equal exact
    within C.22's bound, no escalation but the forced one, and the verified
    pipeline's lists equal to the exact one's."""
    from recommendit_tpu_torch.ops import topk

    paths, data = small_artifacts
    # blocked passes at this size too (the card's Q=1,024 takes them)
    monkeypatch.setattr(topk, "_DENSE_LIMIT", 4 * 5000)
    rec = chip_smoke.verified_phase(paths, data, "cpu", 0, "cpu", qs=(1, 8),
                                    k=50, batch=64, timer=_host_ms)
    assert [c["q"] for c in rec["checks"]] == [1, 8]
    for c in rec["checks"]:
        assert c["escalations"] == {"count": 0, "bound": 0}
        assert c["forced_escalations"] == 1 and c["d_func"] == 17
        assert c["count"]["max_err_over_bound"] <= 1.0
        assert all(c[f"{m}_ms"] > 0 for m in ("verified", "exact", "fused", "bound"))
    assert rec["serve"]["lists_equal"] and rec["serve"]["users"] == 64
    assert rec["serve"]["escalations"] == {"count": 0, "bound": 0}


def test_certified_check_catches_a_wrong_value():
    q = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    corpus = torch.randn(50, 8, generator=torch.Generator().manual_seed(1))
    v, i = torch.topk(q @ corpus.T, 5)
    rec = chip_smoke._certified_check((v, i), (v, i), q, corpus, 8)
    assert rec["ids_differ"] == 0 and rec["max_abs_err"] == 0.0
    with pytest.raises(AssertionError, match="bound"):
        chip_smoke._certified_check((v + 1e-3, i), (v, i), q, corpus, 8)


def test_host_table_phase_checks_pass(tmp_path):
    """The host-table phase through the scale script at a tiny size: no BPR
    launch on the CPU, the streamed catalog equal to the model's."""
    args = ("--config", "ml1m", "--ratings", "3000", "--epochs", "2", "--batch", "64",
            "--dim", "8", "--prefetch", "2", "--loss-mode", "in_batch")
    rec = chip_smoke.host_table_phase("cpu", 0, tmp_path, "cpu", args=args)
    for mode in ("host", "hbm"):
        assert rec[mode]["steps"] == 2 * (3000 // 64)
        assert rec[mode]["launches"] == {"bpr_fwd": 0, "bpr_bwd": 0}
    assert rec["catalog_max_abs_err"] <= chip_smoke.HOST_CATALOG_TOL
    assert rec["index_items"] == 3952 and (rec["batch"], rec["dim"]) == (64, 8)
    assert set(rec["host"]["parts_ms_per_step"][0]) == {
        "gather", "wait", "step", "d2h", "apply_grad"}



def test_ctr_phase_checks_pass():
    """The CTR phase at a tiny size on the CPU: (a) both modes trained and
    evaluated through ``ctr_train`` with the quality checks, (b) the steps
    "on the card" (here the CPU) against the CPU, equal, (c) the profiled
    steps grouped by part of the step, (d) both table modes at scale."""
    rec = chip_smoke.ctr_phase(
        "cpu", 0, "cpu",
        train_args=("--examples", "6000", "--users", "200", "--items", "100",
                    "--epochs", "3", "--batch-size", "512"),
        scale_data=dict(n_examples=5000, n_users=3000, n_items=500),
        scale_dim=8, scale_batch=1024, check_steps=2, profile_steps=3)
    joint, plain = rec["joint"], rec["plain"]
    assert joint["steps_per_epoch"] == plain["steps_per_epoch"] == 10
    assert len(joint["losses"]) == len(joint["ms_per_step"]) == 3
    assert joint["report"]["recall@50"] > joint["random_recall@50"]
    assert "recall@10" not in plain["report"] and plain["report"]["joint"] is False
    tensors = rec["card_vs_cpu"]["tensors"]
    assert {"embed", "top_w1", "accum"} <= set(tensors)
    assert all(t["max_abs_err"] == 0.0 and t["beyond_tight"] == 0 and t["rel_l2"] == 0.0
               for t in tensors.values())
    assert tensors["embed"]["max_move"] > 0
    assert rec["card_vs_cpu"]["losses"] == rec["card_vs_cpu"]["cpu_losses"]
    assert {"gather", "towers", "mlp", "interaction", "softmax", "loss", "backward",
            "adamw", "sparse_update", "other"} == set(rec["profile"]["groups_us_per_step"])
    assert rec["profile"]["device_idle_share"] is None     # not measured on the CPU
    sc = rec["scale"]
    assert sc["table_rows"] == 3000 + 397 + 500 + 1263
    assert sc["sparse"]["steps"] == sc["dense"]["steps"] == 4
    assert sc["dense_over_sparse_ms"] > 0

def test_host_pipeline_phase_checks_pass(trained):
    """``embeddings`` and ``index`` with ``HOST_TABLE=True`` on the train
    data's ``.dat`` files: Recall@20 above random."""
    from recommendit_tpu_torch.data.movielens import save_movielens

    data, _, _, _, tmp = trained
    save_movielens(data, str(tmp / "pipeline" / "ml"))
    rec = chip_smoke.host_pipeline_phase(data, "cpu", 0, tmp, "cpu", epochs=4,
                                         dim=16, hidden=32, batch=256)
    assert rec["launches"] == {"bpr_fwd": 0, "bpr_bwd": 0} and rec["steps"] > 0
    assert rec["recall@20"] > rec["random_recall@20"]
    assert set(rec["stage_s"]) == {"embeddings", "index"}
