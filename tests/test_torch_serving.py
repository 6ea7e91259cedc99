"""Serve-path parity: the JAX pipeline and the torch port serve the same
saved artifacts (random weights, no training) and must agree.

Settings: synthetic 200 users x 1,200 items, dim 16, INDEX_MODE=fused over
an f32 corpus, TOP_K_CANDIDATES=64 — the JAX pipeline then retrieves
through the Pallas window kernel (interpret mode on the CPU) at W=8, and
the port through the kernel's plain twin on the same route.
Tolerances: final scores 1e-4 (ranker standardisation over 64 candidates
amplifies f32 summation-order noise), retrieval scores 1e-5.

The fixture runs twice: with a ranker trained without ``query_norm``
against the JAX pipeline as it is, and with ``query_norm`` against the JAX
pipeline whose scorer shifts each candidate set by its first row before
standardising — the port's rule. Unshifted, a column that is constant over
the candidates standardises to rounding noise (a mean ~1e-7 off the value,
divided by std + 1e-6), and no two frameworks round it alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings

N_USERS, N_ITEMS, DIM = 200, 1200, 16


def _shifted_jax_scorer(self):
    """``LambdaRankScorer.make_device_scorer`` with the port's first-row
    shift before the query norm; everything else as in the JAX package."""
    from recommendit_tpu.models.ranker import mlp_score

    params, qn = self.params, self.query_norm
    mean, std = jnp.asarray(self.feat_mean), jnp.asarray(self.feat_std)

    def score(x):
        h = (x - mean) / std
        if qn:
            h = h - h[..., :1, :]
            m = h.mean(axis=-2, keepdims=True)
            s = h.std(axis=-2, keepdims=True) + 1e-6
            h = (h - m) / s
        return mlp_score(params, h)

    return score


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain_ranker", "query_norm_ranker"])
def served(request, tmp_path_factory):
    query_norm = request.param
    import recommendit_tpu.ops.pallas_mips as pm
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.features.schema import FEATURE_COLUMNS
    from recommendit_tpu.models.ranker import LambdaRankScorer, init_mlp
    from recommendit_tpu.models.retrieval import MIPSIndex
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu.serving.recommender import (
        RecommendationPipeline as JaxPipeline,
    )
    from recommendit_tpu.training.train_embeddings import build_genre_table
    from recommendit_tpu_torch.data.synthetic import (
        make_synthetic_movielens as torch_synth,
    )
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    tmp = tmp_path_factory.mktemp("torch_serving")
    rng = np.random.default_rng(11)
    data = make_synthetic_movielens(n_users=N_USERS, n_items=N_ITEMS,
                                    n_ratings=20_000, seed=5)
    model = TwoTowerModel(N_USERS, N_ITEMS, DIM, 32, seed=0)
    model.params["item_bias"] = jnp.asarray(
        rng.normal(size=N_ITEMS + 1), jnp.float32)
    model.save(str(tmp / "two_tower.npz"))
    item_ids = np.arange(1, N_ITEMS + 1)
    genres = build_genre_table(data.movies, N_ITEMS)[1:]
    index = MIPSIndex(DIM, mode="fused", dtype="float32")
    index.build(model.get_item_embeddings(item_ids, genres), item_ids,
                bias=0.05 * model.item_bias_np(item_ids))
    index.save(str(tmp / "mips.index.npz"))
    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(32, 16),
                              query_norm=query_norm)
    ranker.params = init_mlp(jax.random.PRNGKey(1), len(names), (32, 16))
    ranker.feat_mean = rng.normal(size=len(names)).astype(np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker._trained = True
    ranker.save(str(tmp / "ranker.npz"))

    cfg = Settings(EMBEDDING_DIM=DIM, INDEX_MODE="fused", INDEX_DTYPE="float32",
                   TOP_K_CANDIDATES=64, STAGE_RECAL_EVERY=0, FILTER_SEEN=True,
                   RANKER_BLEND_RETRIEVAL=1.0)
    paths = dict(model_path=str(tmp / "two_tower.npz"),
                 index_path=str(tmp / "mips.index.npz"),
                 ranker_path=str(tmp / "ranker.npz"),
                 features_dir=str(tmp / "features"), cfg=cfg)

    windows = []
    real = pm.mips_topk_window_im

    def spy(queries, item_embs, k, block_items, window, *args):
        windows.append(window)
        return real(queries, item_embs, k, block_items, window, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm, "mips_topk_window_im", spy)
        if query_norm:
            mp.setattr(LambdaRankScorer, "make_device_scorer",
                       _shifted_jax_scorer)
        jp = JaxPipeline(redis_url="redis://localhost:9999",
                         data_dir=str(tmp / "ml"), **paths)
        jp.load(data)   # writes the packed .npy snapshots the port reads
        jax_batch = [np.asarray(a) for a in jp._serve_batch_fn(
            jnp.arange(1, N_USERS + 1, dtype=jnp.int32))]
    tp = RecommendationPipeline(device="cpu", **paths)
    tp.load(torch_synth(n_users=N_USERS, n_items=N_ITEMS, n_ratings=20_000,
                        seed=5))   # the JAX data drawn again as arrays
    return jp, tp, jax_batch, windows


def _split(ids, scores):
    """Rows' finite (ranked) part and the set of -inf (seen) ids."""
    fin = np.isfinite(scores)
    return ids[fin], scores[fin], set(ids[~fin].tolist())


def assert_same_ranking(t_ids, t_scores, j_ids, j_scores, atol=1e-4):
    """Same ranked ids with scores within ``atol``; two items may trade
    places only where their JAX scores lie within ``atol`` of each other
    (a near-tie that f32 summation order can flip). Returns the number of
    positions whose ids differ."""
    ti, ts, tseen = _split(np.asarray(t_ids), np.asarray(t_scores))
    ji, js, jseen = _split(np.asarray(j_ids), np.asarray(j_scores))
    assert tseen == jseen
    assert sorted(ti.tolist()) == sorted(ji.tolist())
    np.testing.assert_allclose(ts, js, atol=atol)
    j_score_of = dict(zip(ji.tolist(), js.tolist()))
    np.testing.assert_allclose([j_score_of[i] for i in ti.tolist()], ts,
                               atol=atol)
    return int((ti != ji).sum())


class TestServeBatchParity:
    def test_jax_took_the_window_kernel(self, served):
        from recommendit_tpu_torch.ops.mips_window import fused_route

        _, _, _, windows = served
        assert windows and set(windows) == {8}
        assert fused_route(N_USERS, N_ITEMS, 64) == ("kernel", 8)

    def test_ids_and_scores_match(self, served):
        _, tp, (j_ids, j_scores, j_rvals), _ = served
        t_ids, t_scores, t_rvals = (
            t.numpy() for t in tp.serve_batch(np.arange(1, N_USERS + 1)))
        assert t_ids.shape == j_ids.shape == (N_USERS, 64)
        swapped = sum(assert_same_ranking(t_ids[r], t_scores[r], j_ids[r],
                                          j_scores[r])
                      for r in range(N_USERS))
        assert swapped <= 0.01 * N_USERS * 64

    def test_retrieval_scores_match(self, served):
        _, tp, (j_ids, j_scores, j_rvals), _ = served
        t_ids, t_scores, t_rvals = (
            t.numpy() for t in tp.serve_batch(np.arange(1, N_USERS + 1)))
        for r in range(N_USERS):
            j_rval_of = dict(zip(j_ids[r].tolist(), j_rvals[r].tolist()))
            np.testing.assert_allclose(
                [j_rval_of[i] for i in t_ids[r].tolist()], t_rvals[r],
                atol=1e-5)


class TestRequestParity:
    @pytest.mark.parametrize("user", [1, 7, 23, 42, 77, 100, 131, 150, 188, 200])
    def test_get_recommendations(self, served, user):
        jp, tp, _, _ = served
        jr = jp.get_recommendations(user, k=20, use_cache=False)
        tr = tp.get_recommendations(user, k=20, use_cache=False)
        assert len(tr) == len(jr) == 20
        assert_same_ranking([r.item_id for r in tr], [r.score for r in tr],
                            [r.item_id for r in jr], [r.score for r in jr])
        meta = {r.item_id: (r.title, r.genres) for r in jr}
        assert all(meta[r.item_id] == (r.title, r.genres) for r in tr)

    def test_unknown_user_fallback(self, served):
        jp, tp, _, _ = served
        jr = jp.get_recommendations(10_000, k=15, use_cache=False)
        tr = tp.get_recommendations(10_000, k=15, use_cache=False)
        assert [r.item_id for r in tr] == [r.item_id for r in jr]
        assert [r.score for r in tr] == [r.score for r in jr]

    def test_failed_serve_falls_back_to_popularity(self, served, monkeypatch):
        """An exception from the serve call is logged and the request gets
        the popularity list, in both pipelines."""
        jp, tp, _, _ = served

        def fail(*args):
            raise RuntimeError("serve path down")
        monkeypatch.setattr(jp, "_serve_fn", fail)
        monkeypatch.setattr(tp, "serve", fail)
        jr = jp.get_recommendations(7, k=15, use_cache=False)
        tr = tp.get_recommendations(7, k=15, use_cache=False)
        assert [r.item_id for r in tr] == [r.item_id for r in jr]
        assert [r.item_id for r in tr] == tp._popularity_fallback[:15]

    def test_batch_recommend(self, served):
        jp, tp, _, _ = served
        users = [3, 9, 10_000, 55, 190]
        assert (tp.batch_recommend(users, k=30, batch_size=8)
                == jp.batch_recommend(users, k=30, batch_size=8))

    def test_backfill_keeps_k_unseen(self, served):
        _, tp, _, _ = served
        recs = tp.get_recommendations(5, k=60, use_cache=False)
        assert len(recs) == 60
        seen = tp._seen.contains(np.full(60, 5), [r.item_id for r in recs])
        assert not seen.any()

    def test_cache_round_trip(self, served):
        _, tp, _, _ = served
        first = tp.get_recommendations(12, k=10)
        again = tp.get_recommendations(12, k=10)
        assert again == first
        assert tp.get_stats()["cache_hits"] >= 1
        tp.feature_store.invalidate_recommendations(12)
        assert tp.feature_store.get_cached_recommendations(12) is None

    def test_stage_split_measured(self, served):
        _, tp, _, _ = served
        cal = tp.recalibrate_stage_split()
        assert cal["measured"] and cal["timer"] == "host"
        assert 0.05 <= cal["retrieval_fraction"] <= 0.95
        assert tp._calls_since_recal == 0


def test_load_from_the_ports_movielens_data(served):
    """``load`` takes the port's own container (arrays, no frames): the
    same serve path, titles and genre lists as a load from the JAX one."""
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    jp, tp, _, _ = served
    data = make_synthetic_movielens(n_users=N_USERS, n_items=N_ITEMS,
                                    n_ratings=20_000, seed=5)
    p2 = RecommendationPipeline(
        model_path=tp.model_path, index_path=tp.index_path,
        ranker_path=tp.ranker_path, features_dir=tp.features_dir,
        cfg=tp.cfg, device="cpu")
    p2.load(data)
    for x, y in zip(tp.serve_batch([4, 8, 15]), p2.serve_batch([4, 8, 15])):
        assert torch.equal(x, y)
    assert p2._item_titles == jp._item_titles
    assert p2._item_genres == jp._item_genres
    assert p2._popularity_fallback == jp._popularity_fallback
    np.testing.assert_array_equal(p2._seen.cols, tp._seen.cols)


def test_load_from_plain_arrays(served):
    """The card has no pandas: load() from numpy arrays gives the same
    serve path as load() from a MovieLensData."""
    from recommendit_tpu_torch.serving.recommender import (
        RecommendationPipeline,
        ServeData,
    )

    _, tp, _, _ = served
    seen = tp._seen
    users = np.repeat(np.arange(len(seen.indptr) - 1), np.diff(seen.indptr))
    data = ServeData(user_id=users, item_id=seen.cols, n_users=N_USERS,
                     n_items=N_ITEMS)
    p2 = RecommendationPipeline(
        model_path=tp.model_path, index_path=tp.index_path,
        ranker_path=tp.ranker_path, features_dir=tp.features_dir,
        cfg=tp.cfg, device="cpu")
    p2.load(data)
    a = tp.serve_batch([4, 8, 15])
    b = p2.serve_batch([4, 8, 15])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
