"""The int8 path of the port against the JAX package on the CPU.

Bit for bit (the same f32 operations in the same order, and JAX's
``jax.random.uniform`` reproduced by the port's threefry counter):
``threefry_uniform``, ``quantize_int8`` (both modes), the kernel-7 twin
against ``quantize_int8_pallas`` in interpret mode, ``quantize_queries``
against the jitted ``_quantize_queries``, and the saved int8 index files.

Searches: ids equal after ``canonical_tie_order``, values within 1e-6 (the
int8 dot is exact on both sides; the scales multiply in the same order, and
1e-6 leaves room for XLA fusing the two scale multiplies differently).
The serve pipeline: as ``tests/test_torch_serving.py``, final scores within
1e-4, retrieval scores within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings
from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
from recommendit_tpu.ops import pallas_mips as jpm
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu.ops.quantize import (
    dequantize_int8 as jax_dequantize,
    quantize_int8_jnp,
    quantize_int8_pallas,
)
from recommendit_tpu_torch.models import MIPSIndex
from recommendit_tpu_torch.ops import mips_window as mw
from recommendit_tpu_torch.ops import quantize as qz
from recommendit_tpu_torch.ops import topk


def _rows(n, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


def _unit_rows(n, d, seed):
    x = _rows(n, d, seed)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _canon_t(v, i):
    return [a.numpy() for a in topk.canonical_tie_order(torch.as_tensor(v),
                                                        torch.as_tensor(i))]


def _canon_j(v, i):
    return [np.asarray(a) for a in jtopk.canonical_tie_order(jnp.asarray(v),
                                                             jnp.asarray(i))]


def assert_same_topk(t, j, atol=1e-6):
    (tv, ti), (jv, ji) = _canon_t(*t), _canon_j(*j)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=0)


# --- the quantizers ------------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 42, 7, -1, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(5, 7), (300, 129), (3,), (1, 1), (1, 70_000)])
def test_threefry_uniform_equals_jax(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32)).ravel()
    got = qz.threefry_uniform(seed, want.size, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if want.size > 10:
        np.testing.assert_array_equal(qz.threefry_uniform(seed, 7, 3, device="cpu").numpy(),
                                      want[3:10])


def test_threefry_rejects_seeds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        qz.threefry_uniform(2 ** 31, 4, device="cpu")


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("n,d", [(1000, 129), (257, 32), (1, 5)])
def test_quantize_int8_equals_jax(stochastic, seed, n, d):
    x = _rows(n, d, seed + n)
    if n > 1:
        x[1] = 0.0                      # a zero row: scale 1e-12 / 127
    jv, js = quantize_int8_jnp(jnp.asarray(x), jax.random.PRNGKey(seed), stochastic)
    tv, ts = qz.quantize_int8(torch.as_tensor(x), seed, stochastic)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(qz.dequantize_int8(tv, ts).numpy(),
                                  np.asarray(jax_dequantize(jv, js)))


def test_quantize_int8_by_chunks_equals_at_once(monkeypatch):
    x = torch.as_tensor(_rows(1000, 129, 1))
    whole = qz.quantize_int8(x, 5)
    monkeypatch.setattr(qz, "_CHUNK_ELEMS", 1000)          # 7 rows a chunk
    chunked = qz.quantize_int8(x, 5)
    parts = [qz.quantize_int8(x[r:r + 300], 5, row_offset=r)
             for r in range(0, 1000, 300)]
    for got in (chunked, tuple(torch.cat(p) for p in zip(*parts))):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


@pytest.mark.parametrize("row_block", [64, 128])
@pytest.mark.parametrize("seed", [0, 7, 8])
def test_kernel7_twin_equals_pallas(row_block, seed):
    """Ragged N (300 rows: the last block is padded), rows of scale ~3 and
    one zero row."""
    x = _rows(300, 129, seed, scale=3.0)
    x[5] = 0.0
    jv, js = quantize_int8_pallas(jnp.asarray(x), seed=seed, row_block=row_block,
                                  interpret=True)
    tv, ts = qz.quantize_int8_hash_ref(torch.as_tensor(x), seed)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    wv, ws = qz.quantize_int8_hash(torch.as_tensor(x), seed)   # the CPU route
    assert torch.equal(wv, tv) and torch.equal(ws, ts)


def test_kernel7_twin_by_chunks_equals_at_once(monkeypatch):
    x = torch.as_tensor(_rows(500, 33, 2))
    whole = qz.quantize_int8_hash_ref(x, 3)
    monkeypatch.setattr(qz, "_CHUNK_ELEMS", 100)
    chunked = qz.quantize_int8_hash_ref(x, 3)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("d", [17, 129])
def test_quantize_queries_equals_jitted_jax(d):
    """JAX's query quantizer runs inside jitted searches, where XLA folds
    ``absmax / 127`` into ``absmax * float32(1/127)``; so does the port."""
    x = _rows(64, d, 2)
    x[3] = 0.0
    jq, js = jax.jit(jtopk._quantize_queries)(jnp.asarray(x))
    tq, ts = topk.quantize_queries(torch.as_tensor(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# --- the searches -------------------------------------------------------- #

def _int8_corpus(n, d, seed, n_pad=0, negative=False):
    """(queries f32, int8 rows, scales) as JAX quantises them, with
    ``n_pad`` zero rows of scale 0 appended (the fused index's padding).
    ``negative``: every real score is negative."""
    e = _unit_rows(n, d, seed)
    q = _rows(8, d, seed + 1)
    if negative:
        e, q = np.abs(e), -np.abs(q)
    i8, s = quantize_int8_jnp(jnp.asarray(e), jax.random.PRNGKey(seed))
    i8 = np.pad(np.asarray(i8), ((0, n_pad), (0, 0)))
    s = np.pad(np.asarray(s), (0, n_pad))
    return q, i8, s


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n_valid", [None, 2500])
def test_mips_topk_int8_exact_equals_jax(monkeypatch, chunked, n_valid):
    q, e8, s = _int8_corpus(3000, 24, 1)
    if chunked:
        monkeypatch.setattr(topk, "_INT8_SCORE_BUDGET", 8 * 700)
    want = jtopk.mips_topk_int8(jnp.asarray(q), jnp.asarray(e8), jnp.asarray(s),
                                100, 1024, "exact", False, n_valid)
    got = topk.mips_topk_int8(torch.as_tensor(q), torch.as_tensor(e8),
                              torch.as_tensor(s), 100, "exact", n_valid)
    assert got[1].dtype == torch.int64
    assert_same_topk(got, want)


def test_mips_topk_int8_approx_selects_exactly():
    """JAX's approx mode keeps recall >= 0.95; the port's selects the
    exact top-k of the same int8 scores."""
    q, e8, s = _int8_corpus(3000, 24, 2)
    args = (torch.as_tensor(q), torch.as_tensor(e8), torch.as_tensor(s), 100)
    approx, exact = topk.mips_topk_int8(*args, "approx"), topk.mips_topk_int8(*args)
    for a, b in zip(_canon_t(*approx), _canon_t(*exact)):
        np.testing.assert_array_equal(a, b)
    _, ji = jtopk.mips_topk_int8(jnp.asarray(q), jnp.asarray(e8), jnp.asarray(s),
                                 100, 1024, "approx")
    ji = np.asarray(ji)
    recall = np.mean([len(set(a) & set(b)) / 100
                      for a, b in zip(approx[1].tolist(), ji.tolist())])
    assert recall >= 0.95


def test_mips_topk_int8_guards():
    q, e8, s = _int8_corpus(200, 16, 3)
    args = (torch.as_tensor(q), torch.as_tensor(e8), torch.as_tensor(s))
    with pytest.raises(ValueError, match="exceeds corpus size"):
        topk.mips_topk_int8(*args, 201)
    with pytest.raises(ValueError, match="out of range"):
        topk.mips_topk_int8(*args, 10, n_valid=201)
    with pytest.raises(ValueError, match="unknown mips_topk_int8 mode"):
        topk.mips_topk_int8(*args, 10, "verified")


@pytest.mark.parametrize("window", [1, 4, 8])
@pytest.mark.parametrize("n_valid,negative", [(3000, False), (2900, False),
                                              (3001, True)],
                         ids=["all_valid", "masked_tail", "all_negative"])
def test_int8_window_twin_equals_pallas(window, n_valid, negative):
    """The twin under ``mips_topk_window_im_int8`` against the Pallas kernel
    in interpret mode, over a corpus padded with scale-0 rows to a block
    multiple. ``all_negative``: every real score < 0, so a pad row masked
    before its scale (-3e38 · 0 = -0) would win every window it sits in."""
    q, e8, s = _int8_corpus(n_valid, 16, window, n_pad=3072 - n_valid,
                            negative=negative)
    want = jpm.mips_topk_window_im_int8(jnp.asarray(q), jnp.asarray(e8),
                                        jnp.asarray(s), 40, 1024, window, True,
                                        n_valid)
    args = (torch.as_tensor(q), torch.as_tensor(e8), torch.as_tensor(s), 40,
            1024, window, n_valid)
    got = mw.mips_topk_window_im_int8_ref(*args)
    assert_same_topk(got, want)
    assert int(got[1].max()) < n_valid
    if negative:
        assert bool((got[0] < 0).all())
    cpu = mw.mips_topk_window_im_int8(*args)          # the CPU route: the twin
    assert torch.equal(cpu[0], got[0]) and torch.equal(cpu[1], got[1])


@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_int8_window_twin_equals_pallas_at_serve_width(window, case):
    """The serve width: 128 embedding columns and the bias, zero-padded to
    144 as the int8 fused index stores them, 2900 valid rows padded with
    scale-0 rows to 3072. k is every valid window, so each window's maximum
    and first position is compared. ``ties``: rows and queries in {-1, 0,
    1} and one scale, so windows are full of equal scores."""
    n_valid, n = 2900, 3072
    if case == "random":
        q, e8, s = _int8_corpus(n_valid, 129, window, n_pad=n - n_valid)
    else:
        rng = np.random.default_rng(window)
        q = rng.integers(-1, 2, (8, 129)).astype(np.float32)
        e8 = np.pad(rng.integers(-1, 2, (n_valid, 129)).astype(np.int8),
                    ((0, n - n_valid), (0, 0)))
        s = np.pad(np.full(n_valid, 0.25, np.float32), (0, n - n_valid))
    q, e8 = np.pad(q, ((0, 0), (0, 15))), np.pad(e8, ((0, 0), (0, 15)))
    k = -(-n_valid // window)
    want = jpm.mips_topk_window_im_int8(jnp.asarray(q), jnp.asarray(e8),
                                        jnp.asarray(s), k, 1024, window, True,
                                        n_valid)
    got = mw.mips_topk_window_im_int8_ref(
        torch.as_tensor(q), torch.as_tensor(e8), torch.as_tensor(s), k, 1024,
        window, n_valid)
    assert_same_topk(got, want)
    assert int(got[1].max()) < n_valid


def test_int8_window_guards_match_jax():
    q, e8, s = _int8_corpus(1000, 16, 4, n_pad=24)
    args = (torch.as_tensor(q), torch.as_tensor(e8), torch.as_tensor(s))
    with pytest.raises(ValueError, match="item_scales length mismatch"):
        mw.mips_topk_window_im_int8(args[0], args[1], args[2][:-1], 10)
    with pytest.raises(ValueError, match="valid candidate count"):
        mw.mips_topk_window_im_int8(*args, 200, 1024, 8, n_valid=1000)
    with pytest.raises(ValueError, match="multiple of window"):
        mw.mips_topk_window_im_int8(*args, 10, 1000, 64)


@pytest.mark.parametrize("route", ["scan", "exact", "kernel"])
def test_fused_auto_int8_routes_equal_jax(route):
    """Each route of ``mips_topk_fused_auto(scales=…)``: the scan (a small
    batch over > 65,536 rows: ``mips_topk_int8`` approx), the exact scan (a
    corpus too small for W >= 8) and the window kernel."""
    n, n_q, k = {"scan": (70_000, 4, 50), "exact": (3000, 8, 400),
                 "kernel": (20_000, 16, 50)}[route]
    q, e8, s = _int8_corpus(n, 16, 5, n_pad=-n % 4096)
    q = _rows(n_q, 16, 6)
    assert mw.fused_route(n_q, n, k)[0] == route
    want = jpm.mips_topk_fused_auto(jnp.asarray(q), jnp.asarray(e8), k, 4096,
                                    route == "kernel", "default", n,
                                    jnp.asarray(s))
    before = dict(mw.LAUNCHES)
    got = mw.mips_topk_fused_auto(torch.as_tensor(q), torch.as_tensor(e8), k,
                                  4096, n_valid=n, scales=torch.as_tensor(s))
    assert mw.LAUNCHES == before
    assert_same_topk(got, want)


# --- the index and the serve path ----------------------------------------- #

def _catalog(n=3000, d=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            np.arange(1, n + 1), (0.05 * rng.normal(size=n)).astype(np.float32),
            rng.normal(size=(40, d)).astype(np.float32))


def _files(path):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, json.loads(open(str(path) + ".meta.json").read())


@pytest.mark.parametrize("mode", ["exact", "approx", "fused"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_index_equals_jax(tmp_path, mode, with_bias):
    """The same embeddings, ids, bias and seed give the same saved files,
    byte for byte, and the same search results; a JAX-saved file loads
    into the port and searches to the same ids."""
    embs, ids, bias, queries = _catalog()
    bias = bias if with_bias else None
    ji = JaxIndex(16, block_size=1024, mode=mode, dtype="int8", quant_seed=9)
    ti = MIPSIndex(16, block_size=1024, mode=mode, dtype="int8", quant_seed=9, device="cpu")
    ji.build(embs, ids, bias=bias)
    ti.build(embs, ids, bias=bias)
    ji.save(str(tmp_path / "j.npz"))
    ti.save(str(tmp_path / "t.npz"))
    (ja, jm), (ta, tm) = _files(tmp_path / "j.npz"), _files(tmp_path / "t.npz")
    assert tm == jm and tm["quant_seed"] == 9
    assert sorted(ta) == sorted(ja)
    for name in ja:
        assert ta[name].dtype == ja[name].dtype, name
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    rows = 3072 if mode == "fused" else 3000
    assert ti._embs.shape == (rows, 32 if with_bias else 16)
    assert ti._embs.dtype == torch.int8

    tv, tid = ti.batch_search(queries, 200)
    jv, jid = ji.batch_search(queries, 200)
    if mode == "approx":          # JAX selects with approx_max_k here
        recall = np.mean([len(set(a) & set(b)) / 200
                          for a, b in zip(tid.tolist(), jid.tolist())])
        assert recall >= 0.95
    else:
        assert_same_topk((tv, tid), (jv, jid))
    loaded = MIPSIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert loaded.quant_seed == 9 and loaded.has_bias == with_bias
    lv, lid = loaded.batch_search(queries, 200)
    np.testing.assert_array_equal(lid, tid)
    np.testing.assert_array_equal(lv, tv)


def test_int8_index_refuses_verified_mode():
    with pytest.raises(ValueError, match="not available for the int8"):
        MIPSIndex(16, mode="verified", dtype="int8", device="cpu")


def test_int8_index_load_checks_widths(tmp_path):
    embs, ids, bias, _ = _catalog(100)
    ji = JaxIndex(16, mode="exact", dtype="int8")
    ji.build(embs, ids, bias=bias)
    ji.save(str(tmp_path / "j.npz"))
    meta = json.loads((tmp_path / "j.npz.meta.json").read_text())
    meta["embedding_dim"] = 15
    (tmp_path / "j.npz.meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="do not fit"):
        MIPSIndex.load(str(tmp_path / "j.npz"), device="cpu")


def test_index_builder_int8_equals_jax(tmp_path):
    """``IndexBuilder`` hands ``cfg.SEED`` to the index as its quant seed,
    as JAX's does: the same meta, and int8 rows equal wherever the two
    frameworks' towers round the catalog embedding alike."""
    from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu.models.two_tower import init_params as jax_init
    from recommendit_tpu.training.build_index import IndexBuilder as JaxBuilder
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.models.two_tower import from_jax_params
    from recommendit_tpu_torch.training import IndexBuilder

    size = dict(n_users=60, n_items=90, n_ratings=2000, seed=1)
    cfg = Settings(INDEX_MODE="fused", INDEX_DTYPE="int8", SEED=5,
                   EMBEDDING_DIM=16, HIDDEN_DIM=32, RETRIEVAL_BLOCK_ITEMS=64)
    params = jax_init(jax.random.PRNGKey(0), 60, 90, 16, 32)
    params["item_bias"] = jnp.asarray(_rows(1, 91, 3)[0])
    jm = TwoTowerModel(60, 90, 16, 32, params=params)
    tm = from_jax_params({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    JaxBuilder(jax_synth(**size), cfg,
               index_output_path=str(tmp_path / "j.npz")).build(model=jm)
    built = IndexBuilder(make_synthetic_movielens(**size), cfg,
                         index_output_path=str(tmp_path / "t.npz"), device="cpu").build(model=tm)
    (ja, jmeta), (ta, tmeta) = _files(tmp_path / "j.npz"), _files(tmp_path / "t.npz")
    assert tmeta == jmeta and tmeta["quant_seed"] == 5 and built.quant_seed == 5
    assert sorted(ta) == sorted(ja) == ["bias", "embeddings_i8", "item_ids", "scales"]
    assert ta["embeddings_i8"].shape == ja["embeddings_i8"].shape == (128, 17)
    np.testing.assert_array_equal(ta["item_ids"], ja["item_ids"])
    np.testing.assert_array_equal(ta["bias"], ja["bias"])
    np.testing.assert_allclose(ta["scales"], ja["scales"], rtol=1e-5, atol=0)
    diff = np.abs(ta["embeddings_i8"].astype(int) - ja["embeddings_i8"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


N_USERS, N_ITEMS, DIM = 200, 1200, 16


@pytest.fixture(scope="module")
def served_int8(tmp_path_factory):
    """The JAX and the port's pipelines on the same saved artifacts with an
    int8 fused index (the settings of ``tests/test_torch_serving.py``,
    plain ranker): JAX retrieves through the int8 Pallas window kernel in
    interpret mode at W=8, the port through the kernel's twin."""
    import recommendit_tpu.ops.pallas_mips as pm
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.features.schema import FEATURE_COLUMNS
    from recommendit_tpu.models.ranker import LambdaRankScorer, init_mlp
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu.serving.recommender import (
        RecommendationPipeline as JaxPipeline,
    )
    from recommendit_tpu.training.train_embeddings import build_genre_table
    from recommendit_tpu_torch.data.synthetic import (
        make_synthetic_movielens as torch_synth,
    )
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    tmp = tmp_path_factory.mktemp("torch_int8_serving")
    rng = np.random.default_rng(12)
    data = make_synthetic_movielens(n_users=N_USERS, n_items=N_ITEMS,
                                    n_ratings=20_000, seed=6)
    model = TwoTowerModel(N_USERS, N_ITEMS, DIM, 32, seed=1)
    model.params["item_bias"] = jnp.asarray(rng.normal(size=N_ITEMS + 1), jnp.float32)
    model.save(str(tmp / "two_tower.npz"))
    item_ids = np.arange(1, N_ITEMS + 1)
    genres = build_genre_table(data.movies, N_ITEMS)[1:]
    index = JaxIndex(DIM, mode="fused", dtype="int8", quant_seed=4)
    index.build(model.get_item_embeddings(item_ids, genres), item_ids,
                bias=0.05 * model.item_bias_np(item_ids))
    index.save(str(tmp / "mips.index.npz"))
    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(32, 16))
    ranker.params = init_mlp(jax.random.PRNGKey(2), len(names), (32, 16))
    ranker.feat_mean = rng.normal(size=len(names)).astype(np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker._trained = True
    ranker.save(str(tmp / "ranker.npz"))

    cfg = Settings(EMBEDDING_DIM=DIM, INDEX_MODE="fused", INDEX_DTYPE="int8",
                   TOP_K_CANDIDATES=64, STAGE_RECAL_EVERY=0, FILTER_SEEN=True,
                   RANKER_BLEND_RETRIEVAL=1.0)
    paths = dict(model_path=str(tmp / "two_tower.npz"),
                 index_path=str(tmp / "mips.index.npz"),
                 ranker_path=str(tmp / "ranker.npz"),
                 features_dir=str(tmp / "features"), cfg=cfg)
    windows = []
    real = pm.mips_topk_window_im_int8

    def spy(queries, items, scales, k, block_items, window, *args):
        windows.append(window)
        return real(queries, items, scales, k, block_items, window, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm, "mips_topk_window_im_int8", spy)
        jp = JaxPipeline(redis_url="redis://localhost:9999",
                         data_dir=str(tmp / "ml"), **paths)
        jp.load(data)   # writes the packed .npy snapshots the port reads
        jax_batch = [np.asarray(a) for a in jp._serve_batch_fn(
            jnp.arange(1, N_USERS + 1, dtype=jnp.int32))]
    tp = RecommendationPipeline(device="cpu", **paths)
    tp.load(torch_synth(n_users=N_USERS, n_items=N_ITEMS, n_ratings=20_000,
                        seed=6))   # the JAX data drawn again as arrays
    return jp, tp, jax_batch, windows


def test_int8_pipeline_took_the_int8_window_route(served_int8):
    _, tp, _, windows = served_int8
    assert windows and set(windows) == {8}
    assert tp.index.dtype == "int8" and tp.index._embs.dtype == torch.int8
    assert mw.fused_route(N_USERS, N_ITEMS, 64) == ("kernel", 8)


def test_int8_pipeline_batch_matches_jax(served_int8):
    from test_torch_serving import assert_same_ranking

    _, tp, (j_ids, j_scores, j_rvals), _ = served_int8
    t_ids, t_scores, t_rvals = (
        t.numpy() for t in tp.serve_batch(np.arange(1, N_USERS + 1)))
    assert t_ids.shape == j_ids.shape == (N_USERS, 64)
    swapped = sum(assert_same_ranking(t_ids[r], t_scores[r], j_ids[r], j_scores[r])
                  for r in range(N_USERS))
    assert swapped <= 0.01 * N_USERS * 64
    for r in range(N_USERS):
        j_rval_of = dict(zip(j_ids[r].tolist(), j_rvals[r].tolist()))
        np.testing.assert_allclose([j_rval_of[i] for i in t_ids[r].tolist()],
                                   t_rvals[r], atol=1e-5)


@pytest.mark.parametrize("user", [1, 42, 150, 200])
def test_int8_pipeline_requests_match_jax(served_int8, user):
    """Single requests over 1,200 items take the kernel route too (the scan
    needs > 65,536 items)."""
    from test_torch_serving import assert_same_ranking

    jp, tp, _, _ = served_int8
    jr = jp.get_recommendations(user, k=20, use_cache=False)
    tr = tp.get_recommendations(user, k=20, use_cache=False)
    assert len(tr) == len(jr) == 20
    assert_same_ranking([r.item_id for r in tr], [r.score for r in tr],
                        [r.item_id for r in jr], [r.score for r in jr])


def test_int8_pipeline_batch_recommend_matches_jax(served_int8):
    jp, tp, _, _ = served_int8
    users = [3, 9, 10_000, 55, 190]
    assert (tp.batch_recommend(users, k=30, batch_size=8)
            == jp.batch_recommend(users, k=30, batch_size=8))
