"""The port's retrieval drivers (``recommendit_tpu_torch/scripts/``
``recall_10m``, ``capacity_30m``, ``recall_curve``, ``bound_turf``,
``mips_ab``, ``fused_decomp``, ``tail_probe``) against the JAX package's
(``scripts/``) on the CPU, at tiny sizes.

* Each port driver runs with ``--device cpu`` and its report's keys (and
  each row's) are JAX's, read from the JAX script's source with ``ast``
  (the four Pallas drivers call ``pallas_call`` without ``interpret``, so
  JAX's scripts cannot run here).
* ``recall_curve``, ``bound_turf`` and ``tail_probe`` also run JAX's script
  (``runpy``) at the same arguments: recall per mode, ``certified_frac``
  and the shapes equal.
* ``mips_ab``'s and ``fused_decomp``'s variants run on one numpy corpus
  against JAX's (the Pallas kernel in interpret mode): ids equal after
  ``canonical_tie_order``, values within ``tests/test_torch_mips.py``'s
  1e-5.
* ``recall_10m``'s and ``capacity_30m``'s recall equals a recount against
  ``mips_topk_numpy`` on the script's own corpus.
* ``utils/profiling.device_loop_time`` chains its inputs: no two calls see
  the same queries.
"""
import ast
import json
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.ops import pallas_mips as jpm
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu_torch.ops import mips_window as mw
from recommendit_tpu_torch.ops import topk
from recommendit_tpu_torch.ops.quantize import quantize_int8
from recommendit_tpu_torch.scripts import (
    bound_turf,
    capacity_30m,
    fused_decomp,
    mips_ab,
    recall_10m,
    recall_curve,
    tail_probe,
)
from recommendit_tpu_torch.scripts.retrieval_common import recall_rows
from recommendit_tpu_torch.utils.profiling import device_loop_time

ROOT = Path(__file__).resolve().parents[1]
VAL_TOL = 1e-5   # f32 sums in another order (tests/test_torch_mips.py)

# tiny arguments, the same for the port's driver and JAX's
ARGS = {
    "recall_10m": ["--n", "20000", "--d", "16", "--k", "10", "--queries", "6"],
    "capacity_30m": ["--n", "20000", "--d", "16", "--k", "10", "--q", "8",
                     "--recall-queries", "6", "--iters", "2"],
    "recall_curve": ["--n-items", "3000", "--dim", "8", "--k", "20", "--batch", "8",
                     "--block", "1024", "--iters", "2"],
    "bound_turf": ["--n", "256", "--dims", "32", "64", "--q", "8", "--k", "10",
                   "--m", "64", "--iters", "2"],
    "mips_ab": ["--n", "8192", "--d", "16", "--k", "10", "--qs", "4", "8",
                "--iters", "2", "--recall-queries", "4"],
    "fused_decomp": ["--qs", "4", "--k", "10", "--d", "16", "--iters", "2",
                     "--n-dec", "10000", "--n-bin", "8192"],
    "tail_probe": ["--q", "4", "--k", "10", "--n-cand", "200", "--iters", "2"],
}
PORT = {"recall_10m": recall_10m, "capacity_30m": capacity_30m,
        "recall_curve": recall_curve, "bound_turf": bound_turf, "mips_ab": mips_ab,
        "fused_decomp": fused_decomp, "tail_probe": tail_probe}


def _port_args(name, tmp_path):
    return PORT[name].parse_args(ARGS[name] + ["--device", "cpu", "--out",
                                               str(tmp_path / f"{name}.json")])


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    return {name: PORT[name].run(_port_args(name, tmp)) for name in PORT}


def _jax_keys(name):
    """(dict literals' key tuples, keys set by ``d["key"] = ...``) of JAX's
    script."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    dicts, extra = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                for k in node.keys):
            dicts.add(tuple(k.value for k in node.keys))
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant):
                    extra.add(t.slice.value)
    return dicts, extra


@pytest.mark.parametrize("name", list(PORT))
def test_report_keys_are_jax_keys(reports, name):
    report = reports[name]
    dicts, extra = _jax_keys(name)
    assert tuple(report) in dicts, (tuple(report), dicts)
    assert report["platform"] == "cpu"
    for row in report.get("rows", []):
        keys = tuple(row)
        base = tuple(k for k in keys if k not in extra)
        assert base in dicts, (keys, dicts)
        assert keys[:len(base)] == base


@pytest.mark.parametrize("name", list(PORT))
def test_default_out_lies_outside_the_repo(name):
    out = Path(PORT[name].parse_args([]).out).resolve()
    assert ROOT not in out.parents, out


def _run_jax(name, tmp_path):
    out = tmp_path / f"jax_{name}.json"
    argv = [f"{name}.py", *ARGS[name], "--out", str(out)]
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(str(ROOT / "scripts" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = saved
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def jax_reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_drivers")
    return {name: _run_jax(name, tmp)
            for name in ("recall_curve", "bound_turf", "tail_probe")}


def test_recall_curve_matches_jax(reports, jax_reports):
    got, want = reports["recall_curve"], jax_reports["recall_curve"]
    for key in ("n_items", "dim", "k", "batch"):
        assert got[key] == want[key]
    assert [r["mode"] for r in got["rows"]] == [r["mode"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert g["recall@k"] == w["recall@k"], (g, w)
    # the int8 row's recall is not trivially 1 at these arguments
    assert got["rows"][-1]["mode"] == "int8_exact" and got["rows"][-1]["recall@k"] < 1


def test_bound_turf_matches_jax(reports, jax_reports):
    got, want = reports["bound_turf"], jax_reports["bound_turf"]
    assert (got["q"], got["k"], got["m"]) == (want["q"], want["k"], want["m"])
    assert len(got["rows"]) == len(want["rows"]) == 6
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["dim"], g["n"], g["variant"]) == (w["dim"], w["n"], w["variant"])
        assert g.get("certified_frac") == w.get("certified_frac"), (g, w)


def test_tail_probe_matches_jax(reports, jax_reports):
    got, want = reports["tail_probe"], jax_reports["tail_probe"]
    assert [{k: r[k] for k in ("variant", "q", "n_cand", "k")} for r in got["rows"]] == \
        [{k: r[k] for k in ("variant", "q", "n_cand", "k")} for r in want["rows"]]


def test_tail_probe_strategies_give_the_exact_top_k():
    """Every strategy's values equal JAX's exact top-k of the same
    candidates, and its ids hold those values."""
    args = tail_probe.parse_args(ARGS["tail_probe"])
    cand = tail_probe.make_candidates(args.q, args.n_cand)
    want_v, _ = jtopk.fast_topk(jnp.asarray(cand), args.k)
    s = torch.as_tensor(cand)
    for name, fn in tail_probe.variants(args.k):
        v, i = fn(s)
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v), err_msg=name)
        np.testing.assert_array_equal(np.take_along_axis(cand, i.numpy(), 1), v.numpy(),
                                      err_msg=name)


def _same_topk(got, want, label):
    gv, gi = topk.canonical_tie_order(*got)
    wv, wi = jtopk.canonical_tie_order(*want)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=label)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=VAL_TOL,
                               err_msg=label)


def test_mips_ab_variants_match_jax():
    args = mips_ab.parse_args(ARGS["mips_ab"])
    rng = np.random.default_rng(0)
    items_np = rng.normal(size=(args.n, args.d)).astype(np.float32)
    items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
    q = rng.normal(size=(8, args.d)).astype(np.float32)
    items = torch.as_tensor(items_np)
    jax_fns = {
        "xla_approx_rt0.95_f32": lambda qq, it: jtopk.mips_topk_dense(qq, it, args.k, 0.95),
        "fused_window_im_f32": lambda qq, it: jpm.mips_topk_window_im(
            qq, it, args.k, args.block, args.window, True, "default"),
    }
    jax_fns["fused_window_im_bf16"] = jax_fns["fused_window_im_f32"]
    for name, fn, it in mips_ab.variants(args, items, items.to(torch.bfloat16)):
        got = fn(torch.as_tensor(q), it)
        j_it = jnp.asarray(it.float().numpy(), jnp.bfloat16 if it.dtype ==
                           torch.bfloat16 else jnp.float32)
        _same_topk(got, jax_fns[name](jnp.asarray(q), j_it), name)


def test_fused_decomp_variants_match_jax():
    args = fused_decomp.parse_args(ARGS["fused_decomp"])
    rng = np.random.default_rng(0)
    items_dec, items_bin = fused_decomp.make_corpora(rng, args, "cpu")
    q = rng.normal(size=(args.qs[0], args.d)).astype(np.float32)
    k, blk, n_dec = args.k, args.block, args.n_dec
    jax_fns = {
        "dec1M_w64_masked": lambda qq, it: jpm.mips_topk_window_im(
            qq, it, k, blk, 64, True, "default", n_dec),
        "dec1M_w32_masked": lambda qq, it: jpm.mips_topk_window_im(
            qq, it, k, blk, 32, True, "default", n_dec),
        "bin1M_w64_nomask": lambda qq, it: jpm.mips_topk_window_im(
            qq, it, k, blk, 64, True, "default", None),
        "auto_dec1M": lambda qq, it: jpm.mips_topk_fused_auto(
            qq, it, k, blk, True, n_valid=n_dec),
    }
    assert items_dec.shape[0] % blk == 0 and items_dec.shape[0] > n_dec
    for name, fn, it in fused_decomp.variants(args, items_dec, items_bin):
        got = fn(torch.as_tensor(q), it)
        want = jax_fns[name](jnp.asarray(q), jnp.asarray(it.float().numpy(),
                                                         jnp.bfloat16))
        _same_topk(got, want, name)


def _recall_fields(rows):
    return (round(float(np.mean(rows)), 4), round(float(np.min(rows)), 4),
            round(float(np.percentile(rows, 10)), 4))


def test_recall_10m_recall_recounts(reports):
    rep = reports["recall_10m"]
    args = recall_10m.parse_args(ARGS["recall_10m"])
    items_padded = recall_10m.make_corpus(args.n, args.d, args.block, args.seed, "cpu")
    q = recall_10m.make_queries(args.queries, args.d, "cpu")
    _, truth = topk.mips_topk_numpy(q.numpy(), items_padded[:args.n].float().numpy(),
                                    args.k)
    _, fi = mw.mips_topk_window_im(q, items_padded, args.k, args.block,
                                   recall_10m.WINDOW, "default", args.n)
    _, ai = mw.mips_topk_fused_auto(q, items_padded, args.k, args.block, n_valid=args.n)
    assert _recall_fields(recall_rows(fi.numpy(), truth, args.k)) == (
        rep["kernel_recall_at_500_mean"], rep["kernel_recall_at_500_min"],
        rep["kernel_recall_at_500_p10"])
    assert round(float(np.mean(recall_rows(ai.numpy(), truth, args.k))), 4) == \
        rep["approx_scan_recall_at_500_mean"]
    assert rep["bin_model_recall"] == round(1 - (args.k - 1) * 512 / (2 * args.n), 4)
    assert items_padded.shape == (20480, 16) and not items_padded[args.n:].any()


def test_capacity_30m_recall_recounts(reports):
    rep = reports["capacity_30m"]
    args = capacity_30m.parse_args(ARGS["capacity_30m"])
    items, scales = capacity_30m.make_corpus(args.n, args.d, args.block, args.seed, "cpu")
    qr, _ = capacity_30m.make_queries(args, "cpu")
    q_i8, q_scale = topk.quantize_queries(qr)
    # the int8 scores in f64: (q_i8 · e_i8) · s_q · s_item
    _, truth = topk.mips_topk_numpy(q_i8.double().numpy() * q_scale.double().numpy()[:, None],
                                    items[:args.n].double().numpy()
                                    * scales[:args.n].double().numpy()[:, None], args.k)
    _, fi = mw.mips_topk_window_im_int8(qr, items, scales, args.k, args.block,
                                        capacity_30m.WINDOW, args.n)
    rows = recall_rows(fi.numpy(), truth, args.k)
    assert (round(float(np.mean(rows)), 4), round(float(np.min(rows)), 4)) == (
        rep["recall_at_500_vs_int8_exact_mean"], rep["recall_at_500_min"])
    assert not scales[args.n:].any() and items.shape[0] % args.block == 0


def test_capacity_corpus_is_the_same_chunked_or_whole():
    """The threefry counter offset by each chunk's first row: the corpus
    made in chunks equals the rows quantised at once."""
    items, scales = capacity_30m.make_corpus(3000, 16, 1024, 3, "cpu", chunk=700)
    gen = torch.Generator().manual_seed(3)
    x = torch.cat([torch.randn((min(700, 3000 - r0), 16), generator=gen)
                   for r0 in range(0, 3000, 700)])
    want, want_s = quantize_int8(x / x.norm(dim=1, keepdim=True), 3)
    assert torch.equal(items[:3000], want) and torch.equal(scales[:3000], want_s)


def test_device_loop_time_chains_its_inputs():
    seen = []

    def step(q, it):
        seen.append(q.clone())
        return q @ it.T, None

    q0 = torch.randn(4, 8)
    it = torch.randn(16, 8)
    t = device_loop_time(step, q0, it, iters=5, rounds=3)
    assert t > 0 and len(seen) == 5 * 4
    for a in range(len(seen)):
        for b in range(a + 1, len(seen)):
            assert not torch.equal(seen[a], seen[b]), (a, b)
    # each input is the one before with 1e-6 · v[:, :1] of its output added
    # to its first column
    v = seen[0] @ it.T
    want = seen[0].clone()
    want[:, :1].add_(v[:, :1], alpha=1e-6)
    assert torch.equal(seen[1], want) and torch.equal(seen[0], q0)


def test_device_loop_time_reports_every_round():
    """``stats`` gets each timed round's ms an iteration and the host's ms
    to enqueue it; the return is the best round, in seconds."""
    stats = {}
    t = device_loop_time(lambda q: (q * 2,), torch.randn(4, 8), iters=3, rounds=5,
                         stats=stats)
    assert len(stats["round_ms"]) == len(stats["enqueue_ms"]) == 5
    assert t == min(stats["round_ms"]) / 1e3
    assert stats["round_ms"] == stats["enqueue_ms"]       # the host clock, on the CPU
