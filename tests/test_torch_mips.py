"""The port's window MIPS (plain twin of the CUDA kernel), router, top-k and
seen filter against the JAX package on the same inputs.

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_pallas_mips.py`` does. Ids must be equal after
``canonical_tie_order``; values within 1e-5 (f32 sums in another order).
"""
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.ops import pallas_mips as jpm
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu.ops.seen import SeenSet as JaxSeenSet, seen_mask_jnp
from recommendit_tpu_torch.ops import mips_window as mw
from recommendit_tpu_torch.ops import topk
from recommendit_tpu_torch.ops.seen import SeenSet, seen_mask
from recommendit_tpu_torch.scripts import kernel_probe


def _data(q, n, d, seed, dtype=np.float32, normalize=False):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    items = rng.normal(size=(n, d)).astype(np.float32)
    if normalize:
        items /= np.linalg.norm(items, axis=1, keepdims=True)
    return qs, items


def _canon_np(v, i):
    return [np.asarray(a) for a in jtopk.canonical_tie_order(jnp.asarray(v),
                                                             jnp.asarray(i))]


def _canon_t(v, i):
    return [a.numpy() for a in topk.canonical_tie_order(v, i)]


def assert_same_topk(t_out, j_out, atol=1e-5):
    tv, ti = _canon_t(*t_out)
    jv, ji = _canon_np(*j_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=0)


# (Q, N, D, k, window, block_items, n_valid) — the edge cases of
# tests/test_pallas_mips.py: padded corpora, n_valid, window=1, lane width
WINDOW_CASES = [
    (8, 5000, 32, 100, 8, 1024, None),
    (8, 3001, 16, 100, 4, 1024, None),
    (4, 2048, 16, 50, 1, 1024, None),
    (8, 16384, 32, 64, 128, 4096, None),
    (8, 8192, 32, 100, 64, 2048, None),
    (8, 4096, 24, 100, 8, 1024, 3500),
    (5, 4096, 16, 60, 16, 4096, 4001),
]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "-".join(map(str, c)))
def test_window_twin_matches_jax_kernel(case):
    q, n, d, k, w, blk, n_valid = case
    qs, items = _data(q, n, d, seed=n + w)
    j = jpm.mips_topk_window_im(jnp.asarray(qs), jnp.asarray(items), k, blk,
                                w, True, "default", n_valid)
    t = mw.mips_topk_window_im_ref(torch.as_tensor(qs), torch.as_tensor(items),
                                   k, blk, w, "default", n_valid)
    assert_same_topk(t, j)
    if n_valid is not None:
        assert int(t[1].max()) < n_valid


def test_window_wrapper_on_cpu_is_the_twin():
    qs, items = _data(6, 3001, 16, seed=2)
    a = mw.mips_topk_window_im(torch.as_tensor(qs), torch.as_tensor(items),
                               100, 1024, 8)
    b = mw.mips_topk_window_im_ref(torch.as_tensor(qs), torch.as_tensor(items),
                                   100, 1024, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_window_one_is_exact():
    qs, items = _data(4, 2048, 16, seed=1)
    v, i = mw.mips_topk_window_im_ref(torch.as_tensor(qs),
                                      torch.as_tensor(items), 50, 1024, 1)
    vn, idxn = jtopk.mips_topk_numpy(qs, items, 50)
    np.testing.assert_array_equal(i.numpy(), idxn)
    np.testing.assert_allclose(v.numpy(), vn, rtol=1e-4)


def test_bf16_corpus_matches_jax():
    qs, items = _data(8, 4096, 32, seed=5, normalize=True)
    items_bf = jnp.asarray(items, jnp.bfloat16)
    j = jpm.mips_topk_window_im(jnp.asarray(qs), items_bf, 100, 1024, 8, True)
    t = mw.mips_topk_window_im_ref(
        torch.as_tensor(qs), torch.as_tensor(items).to(torch.bfloat16),
        100, 1024, 8)
    assert_same_topk(t, j)


def test_candidates_match_jax_layout():
    """Window maxima and first-occurrence positions, items-major, against
    the JAX kernel's (N/W, Q) outputs — with exact ties planted."""
    qs, items = _data(4, 1024, 8, seed=8)
    items[17] = items[16]          # a tie inside window 2 (W=8)
    items[40:48] = items[40]       # a whole window of equal rows
    cv, ca = mw.window_candidates_ref(torch.as_tensor(qs),
                                      torch.as_tensor(items), 8)
    scores = qs @ items.T
    s3 = scores.reshape(4, 128, 8)
    np.testing.assert_allclose(cv.numpy(), s3.max(-1).T, atol=1e-5)
    np.testing.assert_array_equal(ca.numpy(), s3.argmax(-1).T)
    assert (ca[5].numpy() == 0).all()


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=600, n_valid=500), "exceeds corpus size"),
    (dict(k=10, block_items=1000, window=128), "multiple of window"),
    (dict(k=200, window=32), "valid candidate count"),
    (dict(k=10, n_valid=0), "out of range"),
])
def test_guards_match_jax(kwargs, match):
    qs, items = _data(4, 1024, 16, seed=0)
    args = dict(k=10, block_items=1024, window=8, n_valid=None)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        jpm.mips_topk_window_im(jnp.asarray(qs), jnp.asarray(items),
                                args["k"], args["block_items"], args["window"],
                                True, "default", args["n_valid"])
    with pytest.raises(ValueError, match=match):
        mw.mips_topk_window_im_ref(torch.as_tensor(qs), torch.as_tensor(items),
                                   args["k"], args["block_items"],
                                   args["window"], "default", args["n_valid"])


# queries-major window kernel (JAX _window_kernel / mips_topk_window):
# (Q, N, D, k, window, block_items, n_valid, precision, corpus dtype)
QM_CASES = [
    (8, 5000, 32, 30, 128, 16384, None, "default", "float32"),
    (8, 4096, 24, 100, 8, 1024, 3500, "default", "float32"),
    (6, 3001, 16, 20, 128, 1024, None, "highest", "bfloat16"),
    (5, 4096, 16, 60, 8, 4096, 4001, "highest", "float32"),
    (8, 4096, 32, 100, 8, 1024, None, "default", "bfloat16"),
    (4, 8192, 16, 40, 128, 16384, 8000, "highest", "bfloat16"),
]


@pytest.mark.parametrize("case", QM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_queries_major_window_matches_jax(case):
    q, n, d, k, w, blk, n_valid, prec, dtype = case
    qs, items = _data(q, n, d, seed=n + w + d, normalize=True)
    j_items = jnp.asarray(items, jnp.dtype(dtype))
    j = jpm.mips_topk_window(jnp.asarray(qs), j_items, k, blk, w, True, prec,
                             n_valid)
    t_items = torch.tensor(np.asarray(j_items, np.float32)).to(getattr(torch, dtype))
    t = mw.mips_topk_window_ref(torch.as_tensor(qs), t_items, k, blk, w, prec,
                                n_valid)
    assert_same_topk(t, j)
    cpu = mw.mips_topk_window(torch.as_tensor(qs), t_items, k, blk, w, prec,
                              n_valid)
    assert torch.equal(cpu[0], t[0]) and torch.equal(cpu[1], t[1])


def test_queries_major_candidates_are_items_major_transposed():
    """The two layouts hold the same maxima and positions (the on-card
    form is chip_smoke.py's kernel 2 phase)."""
    qs, items = _data(5, 3001, 16, seed=9)
    items[17] = items[16]          # a tie inside a window
    for w in (4, 64, 128):
        qv, qa = mw.window_candidates_qm(torch.as_tensor(qs),
                                         torch.as_tensor(items), w, 2990)
        iv, ia = mw.window_candidates_ref(torch.as_tensor(qs),
                                          torch.as_tensor(items), w, 2990)
        assert qv.shape == (5, -(-3001 // w))
        assert torch.equal(qv, iv.T) and torch.equal(qa, ia.T)


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=600, n_valid=500), "exceeds corpus size"),
    (dict(k=10, block_items=1000, window=128), "multiple of window"),
    (dict(k=200, window=32), "valid candidate count"),
    (dict(k=10, n_valid=0), "out of range"),
])
def test_queries_major_guards_match_jax(kwargs, match):
    qs, items = _data(4, 1024, 16, seed=0)
    args = dict(k=10, block_items=1024, window=8, n_valid=None)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        jpm.mips_topk_window(jnp.asarray(qs), jnp.asarray(items), args["k"],
                             args["block_items"], args["window"], True,
                             "default", args["n_valid"])
    with pytest.raises(ValueError, match=match):
        mw.mips_topk_window(torch.as_tensor(qs), torch.as_tensor(items),
                            args["k"], args["block_items"], args["window"],
                            "default", args["n_valid"])


def _jax_window_rule(n, k=500):
    """The rule as written in pallas_mips.py:665-677."""
    ratio = -(-n // 16384)
    window = 1 << max(0, ratio - 1).bit_length()
    window = max(8, min(512, window))
    while window > 1 and n // window < max(k, 4 * window):
        window //= 2
    return window


@pytest.mark.parametrize("n", [1200, 16_384, 62_423, 150_000, 1_000_000,
                               1 << 20, 10_000_000])
def test_fused_window_rule(n):
    assert mw.fused_window(n, 500) == _jax_window_rule(n)


def test_fused_routes_at_serve_sizes():
    assert mw.fused_window(1_000_000, 500) == 64
    assert mw.fused_route(1024, 1_000_000, 500) == ("kernel", 64)
    assert mw.fused_route(256, 1_000_000, 500) == ("scan", 0)
    assert mw.fused_route(383, 1_000_000, 500) == ("scan", 0)
    assert mw.fused_route(384, 1_000_000, 500) == ("kernel", 64)
    assert mw.fused_route(4, 62_423, 500) == ("kernel", 8)
    assert mw.fused_route(4, 1200, 500)[0] == "exact"


@pytest.mark.parametrize("n", [1200, 62_423])
def test_fused_auto_matches_jax(n):
    qs, items = _data(4, n, 16, seed=n)
    j = jpm.mips_topk_fused_auto(jnp.asarray(qs), jnp.asarray(items), 500,
                                 4096, True)
    t = mw.mips_topk_fused_auto(torch.as_tensor(qs), torch.as_tensor(items),
                                500, 4096)
    assert_same_topk(t, j)


def test_fused_auto_scan_route_recall():
    """q < 384 over > 65,536 items: the dense scan (JAX: approx_max_k at
    recall 0.95; the port: exact top-k of the same scores)."""
    qs, items = _data(4, 70_000, 16, seed=4)
    t = mw.mips_topk_fused_auto(torch.as_tensor(qs), torch.as_tensor(items),
                                100, 4096, n_valid=69_000)
    j = jtopk.mips_topk(jnp.asarray(qs), jnp.asarray(items[:69_000]), 100,
                        65536, "approx")
    _, exact = jtopk.mips_topk_numpy(qs, items[:69_000], 100)
    ti = t[1].numpy()
    assert int(ti.max()) < 69_000
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(exact, 1))
    j_recall = np.mean([len(set(a) & set(b)) / 100
                        for a, b in zip(np.asarray(j[1]).tolist(), exact.tolist())])
    assert j_recall >= 0.95


def test_precision_is_threaded():
    qs, items = _data(6, 5000, 16, seed=3)
    it_bf = torch.as_tensor(items).to(torch.bfloat16)
    q = torch.as_tensor(qs)
    d = mw.mips_topk_fused_auto(q, it_bf, 100, 4096, "default")
    h = mw.mips_topk_fused_auto(q, it_bf, 100, 4096, "highest")
    assert mw.fused_route(6, 5000, 100) == ("kernel", 8)
    ref_d = mw.mips_topk_window_im_ref(q, it_bf, 100, 4096, 8, "default")
    ref_h = mw.mips_topk_window_im_ref(q, it_bf, 100, 4096, 8, "highest")
    for got, want in ((d, ref_d), (h, ref_h)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    exact = mw.mips_topk_fused_auto(q[:, :], it_bf[:700], 100, 4096, "highest")
    assert mw.fused_route(6, 700, 100)[0] == "exact"
    want = topk.fast_topk(topk.score_matrix(q, it_bf[:700], "highest"), 100)
    assert torch.equal(exact[0], want[0])
    assert not torch.equal(d[0], h[0])
    with pytest.raises(ValueError, match="unknown precision"):
        mw.mips_topk_fused_auto(q, it_bf, 100, 4096, "bf16")


def test_exact_route_on_a_bf16_corpus_matches_jax():
    """The small-corpus exact route over bf16 rows at "default" precision
    scores the f32 queries unrounded (HIGHEST), as JAX's
    ``mips_topk(..., "exact")`` does: values within f32 rounding, ids equal.
    Rounding the queries to bf16 moves the values by up to ~4e-3."""
    qs, items = _data(4, 700, 16, seed=19, normalize=True)
    assert mw.fused_route(4, 700, 100)[0] == "exact"
    j_items = jnp.asarray(items, jnp.bfloat16)
    j = jpm.mips_topk_fused_auto(jnp.asarray(qs), j_items, 100, 4096, True,
                                 "default")
    t_items = torch.tensor(np.asarray(j_items, np.float32)).to(torch.bfloat16)
    t = mw.mips_topk_fused_auto(torch.as_tensor(qs), t_items, 100, 4096,
                                "default")
    assert_same_topk(t, j)


@pytest.mark.parametrize("n_valid", [None, 2900])
def test_mips_topk_exact_matches_jax(n_valid):
    qs, items = _data(8, 3001, 24, seed=6)
    j = jtopk.mips_topk(jnp.asarray(qs), jnp.asarray(items), 200, 4096,
                        "exact", True, n_valid)
    t = topk.canonical_tie_order(*topk.mips_topk(
        torch.as_tensor(qs), torch.as_tensor(items), 200, mode="exact",
        n_valid=n_valid))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-5)


def test_mips_topk_approx_recall():
    qs, items = _data(8, 20_000, 32, seed=7, normalize=True)
    it_bf = torch.as_tensor(items).to(torch.bfloat16)
    _, ti = topk.mips_topk(torch.as_tensor(qs), it_bf, 200, mode="approx")
    _, exact = jtopk.mips_topk_numpy(qs, it_bf.float().numpy(), 200)
    recall = np.mean([len(set(a) & set(b)) / 200
                      for a, b in zip(ti.tolist(), exact.tolist())])
    assert recall >= 0.95
    with pytest.raises(ValueError, match="unknown mips_topk mode"):
        topk.mips_topk(torch.as_tensor(qs), it_bf, 10, mode="verified")


def test_canonical_tie_order_matches_jax():
    rng = np.random.default_rng(0)
    vals = np.round(rng.normal(size=(6, 50)), 1).astype(np.float32)
    idx = rng.permutation(300).reshape(6, 50).astype(np.int64)
    jv, ji = _canon_np(vals, idx)
    tv, ti = _canon_t(torch.as_tensor(vals), torch.as_tensor(idx))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("seed", range(3))
def test_seen_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    users = rng.integers(1, 40, 600)
    items = rng.integers(1, 300, 600)
    js, ts = JaxSeenSet(users, items, 300), SeenSet(users, items, 300)
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    np.testing.assert_array_equal(ts.cols, js.cols)
    assert ts.search_steps == js.search_steps
    qu = rng.integers(0, 45, (8, 1))
    qi = np.concatenate([items[:8, None], rng.integers(1, 300, (8, 30))], 1)
    jm = seen_mask_jnp(*js.device_arrays(), js.search_steps,
                       jnp.asarray(qu), jnp.asarray(qi))
    tm = seen_mask(*ts.device_arrays("cpu"), ts.search_steps,
                   torch.as_tensor(qu), torch.as_tensor(qi))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.contains(qu, qi), js.contains(qu, qi))


def test_seen_mask_empty_set():
    ts = SeenSet(np.zeros(0, np.int64), np.zeros(0, np.int64), 10)
    m = seen_mask(*ts.device_arrays("cpu"), ts.search_steps,
                  torch.tensor([[1]]), torch.tensor([[1, 2, 3]]))
    assert not m.any()


# the keys of scripts/pallas_probe.py's JSON line
JAX_PROBE_KEYS = ("variant", "platform", "n", "d", "q", "k", "block", "window",
                  "precision", "compile_s", "batch_ms", "qps", "ok_vals",
                  "max_val_err", "ok_top1", "recall_at_k")


def test_probe_keys_are_the_jax_probe_keys():
    src = (Path(__file__).resolve().parent.parent / "scripts"
           / "pallas_probe.py").read_text()
    assert all(f'"{key}":' in src for key in JAX_PROBE_KEYS)


@pytest.mark.parametrize("variant", kernel_probe.VARIANTS)
def test_probe_runs_each_variant_on_the_cpu(variant, capsys):
    code = kernel_probe.main(["--variant", variant, "--n", "4096", "--d", "16",
                              "--q", "8", "--k", "20", "--iters", "2",
                              "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0
    assert set(JAX_PROBE_KEYS) <= set(rec)
    assert rec["variant"] == variant and rec["platform"] == "cpu"
    assert rec["ok_vals"] and rec["ok_top1"] and rec["recall_at_k"] > 0.5


def test_probe_reports_a_wrong_result_with_exit_code_2(monkeypatch, capsys):
    real = mw.mips_topk_window_im

    def off_by_one(*args, **kwargs):
        v, i = real(*args, **kwargs)
        return v + 1.0, i
    monkeypatch.setattr(mw, "mips_topk_window_im", off_by_one)
    code = kernel_probe.main(["--variant", "window_im", "--n", "4096", "--d",
                              "16", "--q", "8", "--k", "20", "--iters", "1",
                              "--device", "cpu"])
    assert code == 2
    assert not json.loads(capsys.readouterr().out)["ok_vals"]


def test_probe_on_the_card_without_one_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "recommendit_tpu_torch.scripts.kernel_probe",
         "--variant", "fold", "--n", "4096"],
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs an NVIDIA GPU" in proc.stderr
