"""The port's certified-exact top-k engines and the ``verified`` index mode
against the JAX package's on the same numpy-seeded inputs.

Values are held to C.22's order bound: two f32 sums of the same D terms in
other orders differ by at most 2(D−1)·2⁻²⁴·Σ|q_k·x_k|, so each returned
value is within that bound of JAX's at the same rank. Ids are tie-aware:
after ``canonical_tie_order`` they are equal, or, where two sides differ at
a rank, the f64 score of each side's item is within the bound of that
rank's value (a near-tie that the order of a sum may break either way).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu_torch import ops
from recommendit_tpu_torch.models import MIPSIndex
from recommendit_tpu_torch.ops import topk

EPS32 = 2.0 ** -24


def _data(q, n, d, seed, normalize=False):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    items = rng.normal(size=(n, d)).astype(np.float32)
    if normalize:
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        items /= np.linalg.norm(items, axis=1, keepdims=True)
    return qs, items


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _canon(v, i):
    v, i = topk.canonical_tie_order(torch.as_tensor(_np(v)),
                                    torch.as_tensor(_np(i)).long())
    return v.numpy(), i.numpy()


def assert_topk_equal(got, want, qs, items):
    """``got`` and ``want`` (values, ids) over ``qs`` · ``items``ᵀ: values
    within C.22's bound at every rank, ids equal or tied within it."""
    gv, gi = _canon(*got)
    wv, wi = _canon(*want)
    assert gv.shape == wv.shape
    q64, x64 = np.asarray(qs, np.float64), np.asarray(items, np.float64)
    d = q64.shape[1]
    rows = np.arange(len(q64))[:, None]
    # Σ|q_k·x_k| of each returned item: the scale of its score's rounding
    abs_dot = np.abs(q64) @ np.abs(x64).T
    tol = 2 * (d - 1) * EPS32 * np.maximum(abs_dot[rows, wi], abs_dot[rows, gi])
    assert np.all(np.abs(gv - wv) <= tol), np.max(np.abs(gv - wv) - tol)
    assert all(len(set(r)) == len(r) for r in gi.tolist())
    s64 = q64 @ x64.T
    diff = gi != wi
    if diff.any():
        r, c = np.nonzero(diff)
        assert np.all(np.abs(s64[r, gi[r, c]] - wv[r, c]) <= 2 * tol[r, c])
        assert np.all(np.abs(s64[r, wi[r, c]] - wv[r, c]) <= 2 * tol[r, c])


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("recall_target", [1.0, 0.95])
@pytest.mark.parametrize("n_valid", [None, 2900])
def test_mips_topk_dense_matches_jax(recall_target, n_valid):
    qs, items = _data(6, 3000, 16, seed=1)
    got = topk.mips_topk_dense(*_t(qs, items), 25, recall_target, n_valid)
    want = jtopk.mips_topk_dense(jnp.asarray(qs), jnp.asarray(items), 25,
                                 recall_target, n_valid)
    assert_topk_equal(got, want, qs, items[:n_valid])
    assert int(got[1].max()) < (n_valid or 3000)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("n_valid", [None, 2777])
def test_scan_topk_matches_jax(precision, n_valid):
    """Blocks of 1,000 over 3,000 rows (and a ragged 2,777-row valid
    prefix): the per-block top-k merged as JAX merges it."""
    qs, items = _data(5, 3000, 12, seed=2)
    got = topk._scan_topk(*_t(qs, items), 40, 1000, 0.95, precision, n_valid)
    want = jtopk._scan_topk(jnp.asarray(qs), jnp.asarray(items), 40, 1000, 1.0,
                            jtopk._EXACT if precision == "highest" else None,
                            n_valid)
    assert_topk_equal(got, want, qs, items[:n_valid])


def test_chunked_exact_reduce_matches_jax():
    """A 40,000-wide row: three 16,384-wide chunks (the last padded), the
    winners merged."""
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(3, 40_000)).astype(np.float32)
    gv, gi = topk._chunked_exact_reduce(torch.as_tensor(scores), 300)
    wv, wi = jtopk._chunked_exact_reduce(jnp.asarray(scores), 300)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(np.take_along_axis(scores, gi.numpy(), 1), gv.numpy())


@pytest.mark.parametrize("n,k", [(140_000, 10), (20_000, 10)])
def test_exact_topk_windowed_matches_jax(n, k):
    """Q=4, D=16: at 140,000 rows the window-max pruning engages (2,188
    windows > 4·512); at 20,000 it is degenerate (the direct reduce)."""
    qs, items = _data(4, n, 16, seed=4)
    n_win = -(-n // topk._WINDOW)
    assert (n_win > 4 * 512) == (n == 140_000)
    got = topk._exact_topk(*_t(qs, items), k)
    want = jtopk._exact_topk(jnp.asarray(qs), jnp.asarray(items), k)
    assert_topk_equal(got, want, qs, items)
    assert_topk_equal(got, jtopk.mips_topk_numpy(qs, items, k), qs, items)


def test_windowed_exact_topk_on_tied_scores_matches_jax():
    """Integer scores full of ties over 3,000 windows: values equal, ids
    equal after the canonical order."""
    rng = np.random.default_rng(5)
    scores = rng.integers(-50, 50, size=(3, 192_000)).astype(np.float32)
    gv, gi = topk._windowed_exact_topk(torch.as_tensor(scores), 40)
    wv, wi = jtopk._windowed_exact_topk(jnp.asarray(scores), 40)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(np.take_along_axis(scores, gi.numpy(), 1), gv.numpy())
    want = np.sort(scores, axis=1)[:, ::-1][:, :40]
    np.testing.assert_array_equal(gv.numpy(), want)


def test_exact_topk_column_chunks_match_jax(monkeypatch):
    """A score budget of 4 x 16,384 entries at Q=4: 16,384-column chunks,
    three over 40,000 rows (the last padded with -inf)."""
    for mod in (topk, jtopk):
        monkeypatch.setattr(mod, "_SCORE_BUDGET", 4 * 16_384)
    qs, items = _data(4, 40_000, 8, seed=6)
    assert topk._score_chunk(4) == 16_384
    got = topk._exact_topk(*_t(qs, items), 50)
    want = jtopk._exact_topk(jnp.asarray(qs), jnp.asarray(items), 50)
    assert_topk_equal(got, want, qs, items)


@pytest.mark.parametrize("dense", [True, False])
def test_count_above_matches_jax(dense):
    qs, items = _data(5, 2500, 16, seed=7)
    # thresholds halfway between two scores, clear of any rounding
    s = -np.sort(-(qs.astype(np.float64) @ items.T.astype(np.float64)), axis=1)
    tau = ((s[:, 30] + s[:, 31]) / 2).astype(np.float32)
    got = topk._count_above(*_t(qs, items, tau), 700, dense)
    want = jtopk._count_above(jnp.asarray(qs), jnp.asarray(items),
                              jnp.asarray(tau), 700, dense)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dense", [True, False])
def test_verified_topk_matches_jax(monkeypatch, dense):
    """Both branches of pass A and B (the blocked one by a dense limit of 0)
    against JAX's dense branch and against JAX's blocked passes run by
    hand: values, ids and the certificate."""
    qs, items = _data(6, 5000, 16, seed=8)
    if not dense:
        monkeypatch.setattr(topk, "_DENSE_LIMIT", 0)
    gv, gi, gok = topk._verified_topk(*_t(qs, items), 20, 1024)
    wv, wi, wok = jtopk._verified_topk(jnp.asarray(qs), jnp.asarray(items), 20, 1024)
    assert gok.all() and np.asarray(wok).all()
    assert_topk_equal((gv, gi), (wv, wi), qs, items)
    m = 80
    jv, ji = jtopk._scan_topk(jnp.asarray(qs), jnp.asarray(items), m,
                              max(1024, 4 * m), 1.0, precision=jtopk._EXACT)
    count = jtopk._count_above(jnp.asarray(qs), jnp.asarray(items), jv[:, 19],
                               1024, dense=False)
    assert np.asarray(jtopk.certify_topk(jv, count, 20)).all()
    assert_topk_equal((gv, gi), (jv[:, :20], ji[:, :20]), qs, items)


@pytest.mark.parametrize("chunked", [False, True])
def test_bound_verified_topk_matches_jax(monkeypatch, chunked):
    """Pass A over bf16-rounded inputs with f32 sums (one score matrix, or
    16,384-column chunks by a small budget), the exact rescore, and the
    certificate: the same flags and values as JAX's."""
    if chunked:
        for mod in (topk, jtopk):
            monkeypatch.setattr(mod, "_SCORE_BUDGET", 4 * 16_384)
    qs, items = _data(4, 40_000, 16, seed=9, normalize=True)
    k, m = 10, 600
    gv, gi, gok = topk._bound_verified_topk(*_t(qs, items), k, m)
    wv, wi, wok = jtopk._bound_verified_topk(jnp.asarray(qs), jnp.asarray(items), k, m)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    assert gok.all()
    assert_topk_equal((gv, gi), (wv, wi), qs, items)
    assert_topk_equal((gv, gi), jtopk.mips_topk_numpy(qs, items, k), qs, items)


def test_bound_pass_scores_in_f32_from_bf16_inputs():
    """The bound method's pass A: bf16-rounded operands, f32 products and
    sums — not a bf16 matmul, whose bf16 scores break ``_BOUND_C``."""
    qs, items = _data(3, 200, 64, seed=10)
    q_bf = torch.as_tensor(qs).to(torch.bfloat16).float()
    got = topk._bf16_input_scores(q_bf, torch.as_tensor(items))
    assert got.dtype == torch.float32
    ref = (q_bf.double() @ torch.as_tensor(items).to(torch.bfloat16).double().T)
    bound = 2 * 63 * EPS32 * (q_bf.abs().double() @ torch.as_tensor(items).abs()
                              .to(torch.bfloat16).double().T)
    assert ((got.double() - ref).abs() <= bound).all()
    as_bf16 = (q_bf.to(torch.bfloat16) @ torch.as_tensor(items).to(torch.bfloat16).T)
    assert not torch.equal(as_bf16.float(), got)


def test_certificate_passes_on_an_exact_prefilter():
    """``certify_topk`` over JAX's blocked passes (``tests/test_ops.py``):
    the prefilter's top-10 is certified and is the true top-10."""
    rng = np.random.default_rng(11)
    qs = rng.normal(size=(4, 16)).astype(np.float32)
    items = rng.normal(size=(3000, 16)).astype(np.float32)
    vals_m, idx_m = topk._scan_topk(*_t(qs, items), 40, 256, 1.0, "highest")
    count = topk._count_above(torch.as_tensor(qs), torch.as_tensor(items),
                              vals_m[:, 9], 256, dense=False)
    assert topk.certify_topk(vals_m, count, 10).all()
    assert_topk_equal((vals_m[:, :10], idx_m[:, :10]),
                      topk.mips_topk_numpy(qs, items, 10), qs, items)


def test_certificate_catches_missed_item():
    """A candidate list without each query's true argmax fails, in both
    packages."""
    rng = np.random.default_rng(17)
    qs = rng.normal(size=(4, 16)).astype(np.float32)
    items = rng.normal(size=(2000, 16)).astype(np.float32)
    scores = qs @ items.T
    cand_idx = np.argsort(-scores, axis=1)[:, 1:41]
    cand_vals = np.take_along_axis(scores, cand_idx, axis=1)
    count = (scores > cand_vals[:, 9, None]).sum(axis=1)
    got = topk.certify_topk(*_t(cand_vals, count), 10)
    want = jtopk.certify_topk(jnp.asarray(cand_vals), jnp.asarray(count), 10)
    assert not got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_certificate_allows_ties_at_tau():
    cand_vals = np.asarray([[5.0, 4.0, 3.0, 3.0, 2.0]], np.float32)
    assert topk.certify_topk(*_t(cand_vals, np.asarray([2])), 3).all()
    assert not topk.certify_topk(*_t(cand_vals, np.asarray([3])), 3).any()


@pytest.mark.parametrize("method", ["count", "bound"])
@pytest.mark.parametrize("canonical", [False, True])
def test_certified_matches_jax_and_numpy(method, canonical):
    qs, items = _data(8, 5000, 16, seed=23)
    before = dict(topk.ESCALATIONS)
    got = topk.mips_topk_certified(*_t(qs, items), 20, method=method,
                                   canonical=canonical)
    want = jtopk.mips_topk_certified(jnp.asarray(qs), jnp.asarray(items), 20,
                                     method=method, canonical=canonical)
    assert topk.ESCALATIONS == before
    assert_topk_equal(got, want, qs, items)
    assert_topk_equal(got, jtopk.mips_topk_numpy(qs, items, 20), qs, items)
    if canonical:
        v, i = got
        np.testing.assert_array_equal(_canon(v, i)[1], i.numpy())


def test_bound_method_on_a_small_corpus_is_the_exact_path():
    """m = max(k + 512, 4k) ≥ N: JAX goes straight to ``_exact_topk``."""
    qs, items = _data(3, 500, 8, seed=24)
    got = topk.mips_topk_certified(*_t(qs, items), 7, method="bound")
    assert_topk_equal(got, topk._exact_topk(*_t(qs, items), 7), qs, items)
    assert_topk_equal(got, jtopk.mips_topk_certified(
        jnp.asarray(qs), jnp.asarray(items), 7, method="bound"), qs, items)
    with pytest.raises(ValueError, match="unknown certified method"):
        topk.mips_topk_certified(*_t(qs, items), 7, method="nope")


@pytest.mark.parametrize("method,engine,n", [("count", "_verified_topk", 701),
                                             ("bound", "_bound_verified_topk", 1301)])
def test_forced_escalation_is_exact(monkeypatch, method, engine, n):
    """A broken engine (garbage values, every certificate failed) escalates
    the whole batch to the exact path, counted once per call
    (``tests/test_ops.py`` ``TestCertifiedTopK``)."""
    rng = np.random.default_rng(29)
    qs = rng.normal(size=(3, 8)).astype(np.float32)
    items = rng.normal(size=(n, 8)).astype(np.float32)
    real = getattr(topk, engine)

    def broken(*args):
        v, i, _ = real(*args)
        return v * 0 - 1.0, i * 0, torch.zeros(v.shape[0], dtype=torch.bool)

    monkeypatch.setattr(topk, engine, broken)
    before = topk.ESCALATIONS[method]
    got = topk.mips_topk_certified(*_t(qs, items), 7, method=method)
    assert topk.ESCALATIONS[method] == before + 1
    assert_topk_equal(got, jtopk.mips_topk_numpy(qs, items, 7), qs, items)


def test_certificate_exposing_entries_match_jax():
    qs, items = _data(5, 4000, 16, seed=31)
    gv, gi, gok = topk.mips_topk_verified(*_t(qs, items), 15, 1024)
    wv, wi, wok = jtopk.mips_topk_verified(jnp.asarray(qs), jnp.asarray(items), 15, 1024)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    assert_topk_equal((gv, gi), (wv, wi), qs, items)
    gv, gi, gok = topk.mips_topk_bound_verified(*_t(qs, items), 15, 600)
    wv, wi, wok = jtopk.mips_topk_bound_verified(jnp.asarray(qs), jnp.asarray(items), 15, 600)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    assert_topk_equal((gv, gi), (wv, wi), qs, items)


def test_numpy_oracle_is_the_jax_one():
    qs, items = _data(4, 300, 8, seed=32)
    items[7] = items[3]                      # a tie, broken index-ascending
    for a, b in zip(topk.mips_topk_numpy(qs, items, 30),
                    jtopk.mips_topk_numpy(qs, items, 30)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_ops_exports_the_jax_topk_names():
    for name in ("fast_topk", "mips_topk", "mips_topk_bound_verified",
                 "mips_topk_certified", "mips_topk_dense", "mips_topk_int8",
                 "mips_topk_numpy", "mips_topk_verified"):
        assert getattr(ops, name) is getattr(topk, name)


def _catalog(n=3000, d=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            np.arange(1, n + 1), (0.05 * rng.normal(size=n)).astype(np.float32),
            rng.normal(size=(40, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_verified_index_matches_jax(tmp_path, dtype, with_bias):
    """A JAX ``MIPSIndex(mode="verified")`` saved and loaded by the port:
    the mode kept, ``batch_search`` equal to JAX's (ids tie-aware), and
    the port's own save read back by JAX with the same mode."""
    embs, ids, bias, queries = _catalog()
    ji = JaxIndex(16, block_size=1024, mode="verified", dtype=dtype)
    ji.build(embs, ids, bias=bias if with_bias else None)
    ji.save(str(tmp_path / "i.npz"))
    ti = MIPSIndex.load(str(tmp_path / "i.npz"), device="cpu")
    assert (ti.mode, ti.dtype, ti.has_bias) == ("verified", dtype, with_bias)
    assert ti.stats()["recall"] == 1.0
    # both packages rebuild a file's rows the same way (a bf16 file holds
    # the widened bf16 rows, normalised and rounded again on load)
    jl = JaxIndex.load(str(tmp_path / "i.npz"))
    gv, gid = ti.batch_search(queries, 50)
    wv, wid = jl.batch_search(queries, 50)
    # the searches run over the augmented rows [e/|e|, b] and queries [q/|q|, 1]
    rows = np.asarray(jl._embs, np.float32)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    qa = np.concatenate([qn, np.ones((len(qn), 1), np.float32)], 1) if with_bias else qn
    assert_topk_equal((gv, gid - 1), (wv, wid - 1), qa, rows)
    # the port's file read back by both packages (a bf16 file is rebuilt
    # from its widened rows, so each side searches the rebuilt corpus)
    ti.save(str(tmp_path / "p.npz"))
    back = JaxIndex.load(str(tmp_path / "p.npz"))
    again = MIPSIndex.load(str(tmp_path / "p.npz"), device="cpu")
    assert back.mode == again.mode == "verified"
    bv, bid = back.batch_search(queries, 50)
    av, aid = again.batch_search(queries, 50)
    assert_topk_equal((av, aid - 1), (bv, bid - 1), qa, np.asarray(back._embs, np.float32))


def test_verified_index_equals_exact_mode():
    """Over one catalog, verified and exact indexes return the same lists
    (values within the bound, ids tie-aware) through the device searcher,
    and int8 + verified still raises ``ValueError``."""
    embs, ids, bias, queries = _catalog(n=6000, seed=8)
    out = {}
    for mode in ("exact", "verified"):
        index = MIPSIndex(16, block_size=1024, mode=mode, device="cpu")
        index.build(embs, ids, bias=bias)
        out[mode] = index.batch_search(queries, 100)
    rows = index._embs[:, :17].numpy()
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    qa = np.concatenate([qn, np.ones((len(qn), 1), np.float32)], 1)
    v, i = out["verified"]
    assert_topk_equal((v, i - 1), (out["exact"][0], out["exact"][1] - 1), qa, rows)
    with pytest.raises(ValueError, match="int8"):
        MIPSIndex(16, mode="verified", dtype="int8", device="cpu")


@pytest.fixture(scope="module")
def verified_pipelines(tmp_path_factory):
    """JAX's serve pipeline and the port's over one saved artifact set
    (random towers and ranker, a verified f32 index with the bias column,
    ``INDEX_MODE=verified``), and the port's over an exact index of the
    same rows."""
    import jax

    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.features.schema import FEATURE_COLUMNS
    from recommendit_tpu.models.ranker import LambdaRankScorer, init_mlp
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu.serving.recommender import RecommendationPipeline as JaxPipeline
    from recommendit_tpu.training.train_embeddings import build_genre_table
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens as torch_synth
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    n_users, n_items, dim = 120, 900, 16
    tmp = tmp_path_factory.mktemp("verified_serving")
    rng = np.random.default_rng(12)
    data = make_synthetic_movielens(n_users=n_users, n_items=n_items,
                                    n_ratings=8_000, seed=6)
    model = TwoTowerModel(n_users, n_items, dim, 32, seed=0)
    model.params["item_bias"] = jnp.asarray(rng.normal(size=n_items + 1), jnp.float32)
    model.save(str(tmp / "two_tower.npz"))
    item_ids = np.arange(1, n_items + 1)
    genres = build_genre_table(data.movies, n_items)[1:]
    embs = model.get_item_embeddings(item_ids, genres)
    for mode in ("verified", "exact"):
        index = JaxIndex(dim, mode=mode, dtype="float32")
        index.build(embs, item_ids, bias=0.05 * model.item_bias_np(item_ids))
        index.save(str(tmp / f"{mode}.index.npz"))
    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(32, 16))
    ranker.params = init_mlp(jax.random.PRNGKey(1), len(names), (32, 16))
    ranker.feat_mean = rng.normal(size=len(names)).astype(np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker._trained = True
    ranker.save(str(tmp / "ranker.npz"))
    out = {}
    for mode in ("verified", "exact"):
        cfg = Settings(EMBEDDING_DIM=dim, INDEX_MODE=mode, INDEX_DTYPE="float32",
                       TOP_K_CANDIDATES=64, STAGE_RECAL_EVERY=0, FILTER_SEEN=True)
        paths = dict(model_path=str(tmp / "two_tower.npz"),
                     index_path=str(tmp / f"{mode}.index.npz"),
                     ranker_path=str(tmp / "ranker.npz"),
                     features_dir=str(tmp / "features"), cfg=cfg)
        if mode == "verified":
            jp = JaxPipeline(redis_url="redis://localhost:9999",
                             data_dir=str(tmp / "ml"), **paths)
            jp.load(data)   # writes the packed snapshots the port reads
            out["jax"] = jp
        tp = RecommendationPipeline(device="cpu", **paths)
        tp.load(torch_synth(n_users=n_users, n_items=n_items, n_ratings=8_000, seed=6))
        out[mode] = tp
    return out, n_users


def _same_lists(t_ids, t_scores, j_ids, j_scores, atol=1e-4):
    """Ranked ids equal, scores within ``atol``; two ids may trade places
    only where their scores lie within ``atol`` (an f32 near-tie)."""
    t_ids, t_scores = np.asarray(t_ids), np.asarray(t_scores)
    j_ids, j_scores = np.asarray(j_ids), np.asarray(j_scores)
    fin = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(t_scores), fin)
    assert sorted(t_ids[fin].tolist()) == sorted(j_ids[fin].tolist())
    np.testing.assert_allclose(t_scores[fin], j_scores[fin], rtol=0, atol=atol)
    score_of = dict(zip(j_ids[fin].tolist(), j_scores[fin].tolist()))
    np.testing.assert_allclose([score_of[i] for i in t_ids[fin].tolist()],
                               t_scores[fin], rtol=0, atol=atol)


def test_serve_batch_in_verified_mode_matches_jax_and_exact(verified_pipelines):
    """``INDEX_MODE=verified`` through ``load`` and ``serve_batch``: the
    port's lists equal JAX's verified pipeline's and the port's exact
    pipeline's (scores within 1e-4, the serve parity tolerance)."""
    import jax.numpy as jnp

    pipes, n_users = verified_pipelines
    users = np.arange(1, n_users + 1)
    assert pipes["verified"].index.mode == "verified"
    j_ids, j_scores, _ = (np.asarray(a) for a in pipes["jax"]._serve_batch_fn(
        jnp.asarray(users, jnp.int32)))
    v_ids, v_scores, v_rvals = (t.numpy() for t in pipes["verified"].serve_batch(users))
    e_ids, e_scores, e_rvals = (t.numpy() for t in pipes["exact"].serve_batch(users))
    np.testing.assert_allclose(v_rvals, e_rvals, rtol=0, atol=1e-6)
    for r in range(n_users):
        _same_lists(v_ids[r], v_scores[r], j_ids[r], j_scores[r])
        _same_lists(v_ids[r], v_scores[r], e_ids[r], e_scores[r])


@pytest.mark.parametrize("user", [1, 17, 60, 119])
def test_get_recommendations_in_verified_mode(verified_pipelines, user):
    pipes, _ = verified_pipelines
    jr = pipes["jax"].get_recommendations(user, k=20, use_cache=False)
    tr = pipes["verified"].get_recommendations(user, k=20, use_cache=False)
    assert len(tr) == len(jr) == 20
    _same_lists([r.item_id for r in tr], [r.score for r in tr],
                [r.item_id for r in jr], [r.score for r in jr])
    batch = pipes["verified"].batch_recommend([user], k=20)
    assert batch[user] == [r.item_id for r in tr]
