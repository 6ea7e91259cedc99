"""The port's pipeline orchestrator (``pipelines/run_pipeline.py``) against
the JAX one.

The JAX orchestrator runs ``data → features → embeddings → index →
load_features`` on a small synthetic set; the port's ``features`` and
``ranker`` stages train the ranker into the same models directory (two
inner towers, 3 ranker epochs, no query norm, so both serve paths score
alike: C.8), and its ``load_features`` writes its snapshot. Then the JAX and
the port's ``evaluate`` and ``skew`` stages run over that models directory
— the port from its own ``features`` stage, since the two packages' feature
files differ (parquet, ``.npz``). Tolerances: the ranked lists of every
report row identical; every metric within 1e-6; the skew reports equal;
each ``.fsnap`` read by the other package's reader gives equal user and
item dicts, and the two feature stores hold equal dicts.
"""
import json

import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.models import MIPSIndex, TwoTower
from recommendit_tpu_torch.pipelines import run_pipeline
from recommendit_tpu_torch.pipelines.run_pipeline import STAGES, PipelineOrchestrator

CFG = dict(SYNTH_USERS=200, SYNTH_ITEMS=160, SYNTH_RATINGS=12_000,
           EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, TRAIN_EPOCHS=2,
           USE_PALLAS=False, SEED=0, TOP_K_CANDIDATES=60, STAGE_RECAL_EVERY=0,
           RANKER_EPOCHS=3, RANKER_HIDDEN_DIMS=(16, 8), RANKER_CAND_NEGS=20,
           RANKER_QUERY_NORM=False)
EVAL_USERS = 150
ALL = ["data", "features", "embeddings", "index", "ranker", "load_features",
       "skew", "evaluate"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX stages, the port's ranker stage, then the JAX and the port's
    evaluate and skew; the ranked lists each evaluate scores, captured from
    its evaluate_model."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    tmp = tmp_path_factory.mktemp("pipeline")
    common = dict(data_dir=str(tmp / "ml"), models_dir=str(tmp / "models"),
                  synthetic=True, eval_users=EVAL_USERS)
    jorch = jrp.PipelineOrchestrator(cfg=JaxSettings(**CFG),
                                     features_dir=str(tmp / "jax_features"), **common)
    for stage in ("data", "features", "embeddings", "index", "load_features"):
        jorch.run_stage(stage)
    torch_orch = PipelineOrchestrator(cfg=Settings(**CFG),
                                      features_dir=str(tmp / "port_features"),
                                      device="cpu", **common)
    for stage in ("features", "ranker", "load_features"):
        torch_orch.run_stage(stage)

    jax_lists = []
    real = jrp.evaluate_model

    def spy(recs, truth, **kw):
        jax_lists.append(recs)
        return real(recs, truth, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "evaluate_model", spy)
        jax_report = jorch.run_stage("evaluate")
    jax_skew = jorch.run_stage("skew")

    report = torch_orch.run_stage("evaluate")
    written = json.loads((tmp / "models" / "evaluation.json").read_text())
    skew = torch_orch.run_stage("skew")
    return dict(jax_report=jax_report, jax_lists=jax_lists, jax_skew=jax_skew,
                report=report, written=written, skew=skew, orch=torch_orch,
                tmp=tmp)


def test_evaluate_lists_identical(runs):
    lists = runs["orch"].eval_lists
    full, pop, retr = runs["jax_lists"]
    assert lists["full"] == full
    assert lists["popularity"] == pop
    assert lists["retrieval_only"] == retr
    assert len(full) == EVAL_USERS


def test_evaluate_report_matches(runs):
    want, got = runs["jax_report"], runs["report"]
    assert list(got) == list(want)
    for key, v in want.items():
        if isinstance(v, list):
            assert got[key] == v
        else:
            np.testing.assert_allclose(got[key], v, atol=1e-6, rtol=0, err_msg=key)
    assert runs["written"] == json.loads(json.dumps(got, default=float))
    assert "paired_ndcg10_se" in got and "retrieval_only_recall@20" in got
    # the full row is the trained ranker's re-rank, not the retrieval order
    assert runs["orch"].eval_lists["full"] != runs["orch"].eval_lists["retrieval_only"]


def test_ranker_stage_writes_a_trained_ranker(runs):
    from recommendit_tpu.models.ranker import LambdaRankScorer as JaxRanker

    orch = runs["orch"]
    hold = orch.ranker_trainer.holdout_metrics
    assert hold["n_queries"] > 0 and set(hold) >= {"ndcg@10", "ndcg@20",
                                                   "recall@20", "base_ndcg@10"}
    ranker = JaxRanker.load(orch.cfg.RANKER_MODEL_PATH)
    assert ranker.best_iteration >= 1 and len(ranker.feature_names) == 52
    assert orch.stage_times["ranker"] > 0


GBDT_CFG = dict(CFG, RANKER_TYPE="gbdt", GBDT_N_ESTIMATORS=10, GBDT_MAX_DEPTH=3)


@pytest.fixture(scope="module")
def gbdt_runs(runs):
    """``RANKER_TYPE=gbdt`` (the counterpart of ``test_pipeline_e2e.py``'s
    ``test_gbdt_ranker_serves``): the port's ``ranker`` stage trains a GBDT
    into a copy of the models directory (the JAX stages' towers and
    index), then the JAX and the port's ``evaluate`` serve it."""
    import shutil

    import recommendit_tpu.pipelines.run_pipeline as jrp

    tmp = runs["tmp"]
    models = tmp / "models_gbdt"
    models.mkdir()
    for name in ("two_tower.npz", "mips.index.npz"):
        for f in (name, name + ".meta.json"):
            shutil.copy(tmp / "models" / f, models / f)
    common = dict(data_dir=str(tmp / "ml"), models_dir=str(models),
                  synthetic=True, eval_users=EVAL_USERS)
    orch = PipelineOrchestrator(cfg=Settings(**GBDT_CFG),
                                features_dir=str(tmp / "port_features"),
                                device="cpu", **common)
    orch.run_stage("ranker")
    report = orch.run_stage("evaluate")
    jorch = jrp.PipelineOrchestrator(cfg=JaxSettings(**GBDT_CFG),
                                     features_dir=str(tmp / "jax_features"), **common)
    jax_lists = []
    real = jrp.evaluate_model

    def spy(recs, truth, **kw):
        jax_lists.append(recs)
        return real(recs, truth, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "evaluate_model", spy)
        jax_report = jorch.run_stage("evaluate")
    return dict(orch=orch, report=report, jax_report=jax_report,
                jax_lists=jax_lists, models=models)


def test_gbdt_ranker_stage_trains_a_gbdt(gbdt_runs):
    from recommendit_tpu.models import load_ranker as jax_load_ranker
    from recommendit_tpu.models.gbdt import HistGBDTRanker as JaxGBDT

    orch = gbdt_runs["orch"]
    ranker = orch.ranker_trainer.ranker
    assert ranker.model_info()["model_type"] == "hist-gbdt-lambdarank"
    assert ranker.best_iteration >= 1 and len(ranker.feature_names) == 52
    assert orch.ranker_trainer.holdout_metrics["n_queries"] > 0
    back = jax_load_ranker(orch.cfg.RANKER_MODEL_PATH)
    assert isinstance(back, JaxGBDT) and back.model_info() == ranker.model_info()


def test_gbdt_evaluate_lists_identical(gbdt_runs):
    """The same ranked lists in every report row, and every metric within
    1e-6, from the GBDT both packages serve through the fused path."""
    lists = gbdt_runs["orch"].eval_lists
    full, pop, retr = gbdt_runs["jax_lists"]
    assert lists["full"] == full
    assert lists["popularity"] == pop
    assert lists["retrieval_only"] == retr
    assert len(full) == EVAL_USERS and full != retr
    want, got = gbdt_runs["jax_report"], gbdt_runs["report"]
    assert list(got) == list(want)
    for key, v in want.items():
        if isinstance(v, list):
            assert got[key] == v
        else:
            np.testing.assert_allclose(got[key], v, atol=1e-6, rtol=0, err_msg=key)


RETRIEVAL_TOL = 1e-5   # the exact f32 search (tests/test_torch_mips.py)
RANKER_TOL = 1e-5      # the descent's f32 sums over 10 trees (C.22)
F32_U = 2.0 ** -24     # f32's unit roundoff


def _tap(fn, name, log):
    """``fn`` whose outputs are also recorded, as computed inside the
    compiled program that consumes them, under ``log[name]``."""
    import jax

    def record(*xs):
        log.setdefault(name, []).append([np.array(x) for x in xs])

    def tapped(*args):
        out = fn(*args)
        jax.debug.callback(record, *jax.tree_util.tree_leaves(out))
        return out

    return tapped


@pytest.fixture(scope="module")
def gbdt_serve(gbdt_runs):
    """Both packages' ``RecommendationPipeline`` over the GBDT models
    directory, and ``serve_batch`` of every user through each, with the
    two inputs of each blend recorded: JAX's device searcher and ranker
    scorer are tapped inside its compiled serve path, the port's
    ``_blend`` is spied on. JAX's unseen mask is its ``seen_mask_jnp`` of
    the tapped candidates (a boolean, so recomputed exactly)."""
    import jax.numpy as jnp

    from recommendit_tpu.models.gbdt import HistGBDTRanker as JaxGBDT
    from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
    from recommendit_tpu.ops.seen import seen_mask_jnp
    from recommendit_tpu.serving.recommender import RecommendationPipeline as JaxPipeline
    from recommendit_tpu_torch.serving import recommender as port_rec

    models, tmp = gbdt_runs["models"], gbdt_runs["models"].parent
    paths = dict(model_path=str(models / "two_tower.npz"),
                 index_path=str(models / "mips.index.npz"),
                 ranker_path=str(models / "ranker.npz"), data_dir=str(tmp / "ml"),
                 redis_url="redis://localhost:9999")
    log = {}
    real_scorer, real_searcher = JaxGBDT.make_device_scorer, JaxIndex.make_device_searcher
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxGBDT, "make_device_scorer",
                   lambda self: _tap(real_scorer(self), "scores", log))
        mp.setattr(JaxIndex, "make_device_searcher",
                   lambda self, k: _tap(real_searcher(self, k), "retrieve", log))
        jp = JaxPipeline(cfg=JaxSettings(**GBDT_CFG),
                         features_dir=str(tmp / "jax_features"), **paths)
        jp.load()
    tp = port_rec.RecommendationPipeline(cfg=Settings(**GBDT_CFG), device="cpu",
                                         features_dir=str(tmp / "port_features"),
                                         **paths)
    tp.load()

    users = np.arange(1, CFG["SYNTH_USERS"] + 1)
    log.clear()
    jax_out = [np.array(a) for a in jp._serve_batch_fn(jnp.asarray(users, jnp.int32))]
    assert len(log["scores"]) == len(log["retrieve"]) == 1
    (j_raw,), (j_rvals, j_pos) = log["scores"][0], log["retrieve"][0]
    j_cand = np.array(jp.index._ids_dev)[j_pos]
    indptr, cols = jp._seen.device_arrays()
    j_seen = np.array(seen_mask_jnp(indptr, cols, jp._seen.search_steps,
                                    jnp.asarray(users)[:, None], jnp.asarray(j_cand)))

    spied = []
    real_blend = port_rec._blend

    def spy(scores, rvals, unseen, beta):
        spied.append((scores.clone(), rvals.clone(), unseen.clone()))
        return real_blend(scores, rvals, unseen, beta)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rec, "_blend", spy)
        t_ids, t_scores, _ = tp.serve_batch(users)
    assert len(spied) == 1
    t_raw, t_rvals, t_unseen = (a.numpy() for a in spied[0])
    t_cand = tp._item_ids_dev[tp._retrieve(tp.model.user_tower(
        torch.as_tensor(users).long()))[1]].numpy()
    return dict(jp=jp, tp=tp, beta=float(GBDT_CFG.get("RANKER_BLEND_RETRIEVAL",
                                                      Settings().RANKER_BLEND_RETRIEVAL)),
                jax_ids=jax_out[0], jax_scores=jax_out[1],
                j_raw=j_raw, j_rvals=j_rvals, j_cand=j_cand, j_unseen=~j_seen,
                t_ids=t_ids, t_scores=t_scores,
                t_raw=t_raw, t_rvals=t_rvals, t_cand=t_cand, t_unseen=t_unseen)


def _port_inputs_in_jax_order(s):
    """The port's blend inputs reordered to JAX's candidate order (the
    same candidate ids in each row, asserted)."""
    j_cand, t_cand = s["j_cand"], s["t_cand"]
    np.testing.assert_array_equal(np.sort(t_cand, 1), np.sort(j_cand, 1))
    at = np.argsort(t_cand, 1)[np.arange(len(j_cand))[:, None],
                              np.argsort(np.argsort(j_cand, 1), 1)]
    take = lambda a: np.take_along_axis(a, at, 1)  # noqa: E731
    np.testing.assert_array_equal(take(t_cand), j_cand)
    return take(s["t_raw"]), take(s["t_rvals"]), take(s["t_unseen"])


def _standardised(x, unseen):
    """Per candidate ``|z_i|`` and ``max|x| / σ`` over each user's unseen
    candidates, in float64 (σ with ddof 0, as the blend)."""
    x = x.astype(np.float64)
    n = unseen.sum(1, keepdims=True)
    mu = np.where(unseen, x, 0).sum(1, keepdims=True) / n
    sd = np.sqrt(np.where(unseen, (x - mu) ** 2, 0).sum(1, keepdims=True) / n)
    return np.abs(x - mu) / sd, np.where(unseen, np.abs(x), 0).max(1, keepdims=True) / sd, sd


def _blend_rounding(s):
    """Per candidate (JAX's order), a bound on one f32 evaluation's
    rounding error of the blend ``z(s) + β·z(r)``. With C candidates and
    ``γ = (C+10)·u / (1 − (C+10)·u)``: the masked mean's sum is off by at
    most ``γ·max|x|`` in any summation order, which moves ``z_i`` by
    ``γ·max|x|/σ``; the variance's sum, the square root and the products
    move it by at most ``γ·|z_i|``. So each ``z`` carries
    ``γ·(max|x|/σ + |z_i|)``. Where σ is small beside |x| (C.61's bunched
    candidates: retrieval values spread little beside their size) two
    correct f32 blends disagree by several 1e-6."""
    c = s["j_raw"].shape[1] + 10
    gamma = c * F32_U / (1 - c * F32_U)
    out = 0.0
    for x, w in ((s["j_raw"], 1.0), (s["j_rvals"], s["beta"])):
        z, peak, _ = _standardised(x, s["j_unseen"])
        out = out + w * gamma * (peak + z)
    return out


def _served(s, per_candidate):
    """``per_candidate`` (JAX's candidate order) at the candidates JAX
    served, in its served order."""
    at = np.argmax(s["j_cand"][:, :, None] == s["jax_ids"][:, None, :], axis=1)
    return np.take_along_axis(per_candidate, at, 1)


def _blend_excess(blend, s) -> float:
    """Largest amount by which ``blend`` fed JAX's own inputs and unseen
    mask strays from JAX's served (blended) scores beyond twice the f32
    rounding bound of one blend (``_blend_rounding``: each of the two
    evaluations may be off by it), at the candidates JAX served; the seen
    candidates' ``-inf`` must fall alike. At most 0 for a correct blend."""
    blended = blend(torch.as_tensor(s["j_raw"]), torch.as_tensor(s["j_rvals"]),
                    torch.as_tensor(s["j_unseen"]), s["beta"])
    blended = blended.masked_fill(~torch.as_tensor(s["j_unseen"]), float("-inf"))
    got = _served(s, blended.numpy())
    want = s["jax_scores"]
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    return float(np.max(err - 2 * _served(s, _blend_rounding(s))[fin]))


def test_gbdt_serve_batch_and_model_info_equal(gbdt_serve):
    """Both packages' ``RecommendationPipeline`` over the GBDT models
    directory: ``serve_batch`` of every user gives identical ids after
    ``canonical_tie_order``, and both apps' ``/model/info`` carry the same
    model and ranker fields. The scores are held stage by stage:

    1. the blend's inputs, each at its own stage: the retrieval value of
       every candidate within ``RETRIEVAL_TOL`` (the exact f32 search) and
       the GBDT's raw score within ``RANKER_TOL`` (C.22), matched by
       candidate id;
    2. the blend itself: the port's ``_blend`` fed JAX's two inputs and
       unseen mask gives JAX's served scores within twice the f32
       rounding bound of one blend (``_blend_rounding``; each of the two
       evaluations may be off by it);
    3. the served scores, within a bound derived from step 1's measured
       input differences. The blend is ``b = z(s) + β·z(r)``, each ``z``
       standardised over a user's n unseen candidates (mean μ, standard
       deviation σ, ddof 0). Moving the inputs by δ moves, to first
       order, ``z_i`` by ``(δ_i − mean δ − z_i·mean(z·δ))/σ``; with
       ``|δ| ≤ Δ`` and ``mean z² = 1`` that is at most
       ``(2 + |z_i|)·Δ/σ``. So a served score may move by
       ``(2 + |z_i^s|)·Δs/σs + β·(2 + |z_i^r|)·Δr/σr``, Δ the user's
       largest input difference and σ, z JAX's; it is held within twice
       that (second-order terms) plus step 2's rounding allowance.
       Unlike one flat tolerance, the bound tightens
       where a user's candidates spread widely and loosens only in
       proportion where they bunch (C.61: a few ulp of a 16-term dot
       product became 1.17e-5 of a blended score).
    """
    from recommendit_tpu.serving import app as jax_app
    from recommendit_tpu_torch.ops.topk import canonical_tie_order
    from recommendit_tpu_torch.serving import app as port_app
    from recommendit_tpu_torch.serving.recommender import _blend

    s = gbdt_serve
    j_scores, j_ids = canonical_tie_order(torch.as_tensor(s["jax_scores"]),
                                          torch.as_tensor(s["jax_ids"]).long())
    t_scores, t_ids = canonical_tie_order(s["t_scores"], s["t_ids"].long())
    assert torch.equal(t_ids, j_ids)
    assert torch.equal(torch.isinf(t_scores), torch.isinf(j_scores))

    # 1. the inputs, stage by stage
    t_raw, t_rvals, t_unseen = _port_inputs_in_jax_order(s)
    unseen = s["j_unseen"]
    np.testing.assert_array_equal(t_unseen, unseen)
    np.testing.assert_allclose(t_rvals, s["j_rvals"], rtol=0, atol=RETRIEVAL_TOL)
    np.testing.assert_allclose(t_raw, s["j_raw"], rtol=0, atol=RANKER_TOL)

    # 2. the blend on identical inputs
    assert _blend_excess(_blend, s) <= 0

    # 3. the served scores under the derived bound
    def _move(t, j):
        """Per candidate, (2 + |z_i|)·Δ/σ over each user's unseen ones."""
        z, _, sd = _standardised(j, unseen)
        delta = np.where(unseen, np.abs(t.astype(np.float64) - j), 0).max(1, keepdims=True)
        return (2 + z) * delta / sd

    move = _move(t_raw, s["j_raw"]) + s["beta"] * _move(t_rvals, s["j_rvals"])
    bound = _served(s, 2 * move + 2 * _blend_rounding(s))
    # in JAX's served order; the port's scores follow its ids there
    t_by_id = {(b, int(i)): float(v) for b, (ids, vals) in enumerate(
        zip(s["t_ids"].tolist(), s["t_scores"].tolist())) for i, v in zip(ids, vals)}
    want = s["jax_scores"]
    got = np.array([[t_by_id[(b, int(i))] for i in row]
                    for b, row in enumerate(s["jax_ids"])])
    fin = np.isfinite(want)
    excess = np.abs(got[fin] - want[fin]) - bound[fin]
    assert np.all(excess <= 0), float(np.max(excess))

    got = port_app.RecommendItApp(pipeline=s["tp"]).handle("GET", "/model/info")
    want = jax_app.RecommendItApp(pipeline=s["jp"]).handle("GET", "/model/info")
    assert got[0] == want[0] == 200
    for key in ("model_version", "embedding_dim", "n_users", "n_items",
                "index_stats", "ranker_info"):
        assert got[1][key] == want[1][key], key
    assert got[1]["ranker_info"]["model_type"] == "hist-gbdt-lambdarank"


def _wrong_blend(eps=1e-9, ddof=0):
    """The port's blend with its variance's ε or its ddof changed."""
    def blend(scores, rvals, unseen, beta):
        m = unseen.float()
        cnt = m.sum(-1, keepdim=True).clamp(min=1.0)

        def _z(x):
            mu = (x * m).sum(-1, keepdim=True) / cnt
            var = (((x - mu) ** 2) * m).sum(-1, keepdim=True) / (cnt - ddof)
            return (x - mu) * torch.rsqrt(var + eps)

        return _z(scores) + beta * _z(rvals)
    return blend


@pytest.mark.parametrize("wrong", [dict(eps=1e-6), dict(ddof=1)],
                         ids=["eps", "ddof"])
def test_gbdt_blend_check_catches_a_wrong_blend(gbdt_serve, wrong):
    """Step 2 of the serve test fails for a blend that differs from JAX's
    only in the ε under its square root or in its ddof, while the
    unchanged copy passes it (so the check tells the blend apart, not the
    copy)."""
    assert _blend_excess(_wrong_blend(), gbdt_serve) <= 0
    assert _blend_excess(_wrong_blend(**wrong), gbdt_serve) > 0


def test_feature_snapshots_open_in_the_other_package(runs):
    from recommendit_tpu.features.snapshot import FeatureSnapshot as JaxSnapshot
    from recommendit_tpu_torch.features.snapshot import FeatureSnapshot

    tmp = runs["tmp"]
    jax_file, port_file = (str(tmp / d / "features.fsnap")
                           for d in ("jax_features", "port_features"))
    readers = [JaxSnapshot(port_file, prefer_native=False), FeatureSnapshot(jax_file),
               FeatureSnapshot(port_file)]
    n_users, n_items = readers[0].n_users(), readers[0].n_items()
    assert all((r.n_users(), r.n_items()) == (n_users, n_items) for r in readers)
    assert n_users > 150 and n_items > 100
    for u in range(0, CFG["SYNTH_USERS"] + 2):
        dicts = [r.user_dict(u) for r in readers]
        assert dicts[0] == dicts[1] == dicts[2], u
    for i in range(0, CFG["SYNTH_ITEMS"] + 2):
        dicts = [r.item_dict(i) for r in readers]
        assert dicts[0] == dicts[1] == dicts[2], i
    got, found = readers[2].gather_items(np.arange(0, 12))
    want, wfound = readers[0].gather_items(np.arange(0, 12))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(found, wfound)


def test_feature_store_holds_the_jax_dicts(runs):
    import pandas as pd

    from recommendit_tpu.features.store import FeatureStore as JaxStore
    from recommendit_tpu_torch.features.snapshot import FeatureSnapshot
    from recommendit_tpu_torch.features.store import FeatureStore

    tmp = runs["tmp"]
    jstore, store = JaxStore(), FeatureStore()
    jstore.load_all_features(pd.read_parquet(tmp / "jax_features" / "user_features.parquet"),
                             pd.read_parquet(tmp / "jax_features" / "item_features.parquet"))
    tables = []
    for name in ("user_features.npz", "item_features.npz"):
        with np.load(tmp / "port_features" / name) as z:
            tables.append({c: z[c] for c in z.files})
    store.load_all_features(*tables, batch_size=64)
    assert store.stats() == jstore.stats()
    for u in range(0, CFG["SYNTH_USERS"] + 2):
        assert store.get_user_features(u) == jstore.get_user_features(u), u
    items = list(range(0, CFG["SYNTH_ITEMS"] + 2))
    assert store.get_item_features_batch(items) == jstore.get_item_features_batch(items)
    assert isinstance(store.get_item_features(1)["title"], str)

    # read-through: a miss falls to the snapshot, a write shadows it
    fresh = FeatureStore()
    snap = FeatureSnapshot(str(tmp / "port_features" / "features.fsnap"))
    fresh.attach_snapshot(snap)
    assert fresh.get_user_features(5) == snap.user_dict(5)
    assert fresh.get_item_features_batch([3])[3] == snap.item_dict(3)
    fresh.store_user_features(5, {"avg_rating": 1.5})
    assert fresh.get_user_features(5) == {"avg_rating": 1.5}
    assert fresh.get_user_features(10_000) is None


def test_store_refuses_redis_it_cannot_use(monkeypatch):
    """With the redis package importable but no server answering, the store
    takes the in-memory backend, as JAX's does
    (``tests/test_torch_store_redis.py`` holds the Redis backend itself)."""
    from recommendit_tpu_torch.features import store

    class Unreachable:
        @staticmethod
        def from_url(url, socket_connect_timeout):
            raise ConnectionError(f"{url}: connection refused")

    monkeypatch.setattr(store, "redis", Unreachable)
    monkeypatch.setattr(store, "REDIS_AVAILABLE", True)
    fs = store.FeatureStore("redis://localhost:9999")
    assert not fs.is_redis_available
    assert fs.stats() == {"backend": "in-memory", "keys": 0}


def test_skew_report_matches(runs):
    assert runs["skew"] == runs["jax_skew"]
    assert runs["skew"]["max_kl"] == 0.0 and not runs["skew"]["skew_detected"]
    assert runs["skew"]["n_features_checked"] == 50


def test_skew_sample_is_pandas_sample():
    """``DataFrame.sample(n, random_state=s)`` takes the first n of a
    ``RandomState(s)`` permutation, in that order."""
    import pandas as pd

    frame = pd.DataFrame({"x": np.arange(5000)})
    want = frame.sample(n=4000, random_state=7)["x"].values
    np.testing.assert_array_equal(np.random.RandomState(7).permutation(5000)[:4000],
                                  want)


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    """The port's ``all`` on the CPU (in-batch BPR, the kernels' plain
    twins), then a second ``embeddings`` run that resumes."""
    tmp = tmp_path_factory.mktemp("own")
    orch = PipelineOrchestrator(
        cfg=Settings(**CFG, LOSS_MODE="in_batch"), data_dir=str(tmp / "ml"),
        models_dir=str(tmp / "models"), features_dir=str(tmp / "features"),
        synthetic=True, eval_users=10_000, device="cpu")
    report = orch.run_stage("all")
    stage_times = dict(orch.stage_times)
    skew = json.loads((tmp / "models" / "skew_report.json").read_text())
    with np.load(orch.cfg.EMBEDDING_MODEL_PATH) as z:
        model = {k: z[k] for k in z.files}
    resumed = orch.run_stage("embeddings")
    return orch, report, skew, dict(stage_times=stage_times, model=model,
                                    resumed=resumed, tmp=tmp)


def test_own_pipeline_on_the_cpu(own_run):
    orch, report, skew, more = own_run
    assert list(more["stage_times"]) == ALL
    data = orch._load_data()
    view = orch._train_view()
    seen = {}
    for u, i in zip(view.user_id.tolist(), view.item_id.tolist()):
        seen.setdefault(u, set()).add(i)
    for row, lists in orch.eval_lists.items():
        assert len(lists) == report["n_users"] > 50, row
        for u, items in lists.items():
            assert len(items) == len(set(items)), (row, u)
            assert not set(items) & seen.get(u, set()), (row, u)
            assert all(1 <= i <= data.n_items for i in items)
            if row != "retrieval_only":     # backfilled / the whole catalog
                assert len(items) == 20, (row, u)
    # retrieval-only: the first 20 unseen of the top TOP_K_CANDIDATES, so a
    # user who has seen most of them gets fewer, as in the reference
    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device="cpu")
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device="cpu")
    users = list(orch.eval_lists["retrieval_only"])
    q = np.stack([model.get_user_embedding(u) for u in users])
    _, ids = index.batch_search(q, k=min(CFG["TOP_K_CANDIDATES"], index.n_total))
    short = 0
    for row, u in enumerate(users):
        unseen = [int(i) for i in ids[row] if i not in seen.get(u, set())]
        assert orch.eval_lists["retrieval_only"][u] == unseen[:20]
        short += len(unseen) < 20
    assert short < len(users) // 4
    for key, v in report.items():
        if not isinstance(v, list):
            assert np.isfinite(v), key
    assert skew["max_kl"] == 0.0 and skew["n_features_checked"] == 50


def test_all_writes_every_artifact(own_run):
    from recommendit_tpu.models.ranker import LambdaRankScorer as JaxRanker

    orch, _, _, more = own_run
    models, features = more["tmp"] / "models", more["tmp"] / "features"
    assert (models / "two_tower_ckpt" / "best").is_file()
    assert (features / "features.fsnap").is_file()
    assert (features / "features.fsnap.meta.json").is_file()
    ranker = JaxRanker.load(str(models / "ranker.npz"))
    assert ranker.query_norm is False and ranker.best_iteration >= 1
    hold = orch.ranker_trainer.holdout_metrics
    assert hold["n_queries"] > 0 and 0 <= hold["ndcg@10"] <= 1


def test_embeddings_stage_resumes_from_its_checkpoint(own_run):
    """The best epoch was the last, so the resumed run takes no step and
    writes the same model."""
    orch, _, _, more = own_run
    assert more["resumed"] == []
    with np.load(orch.cfg.EMBEDDING_MODEL_PATH) as z:
        assert sorted(z.files) == sorted(more["model"])
        for k in z.files:
            np.testing.assert_array_equal(z[k], more["model"][k], err_msg=k)


def test_cli_stage_list():
    assert STAGES == ["all", "data", "features", "load_features", "embeddings",
                      "index", "ranker", "evaluate", "skew"]
    assert run_pipeline.ALL_STAGES == ALL
    with pytest.raises(SystemExit):
        run_pipeline.main(["--stage", "bogus", "--device", "cpu"])
    orch = PipelineOrchestrator(cfg=Settings(), device="cpu")
    with pytest.raises(ValueError, match="Unknown stage"):
        orch.run_stage("bogus")


def test_cli_needs_a_card_unless_told_cpu(tmp_path):
    """Without ``--device cpu`` the CLI runs on the card, and here, with no
    card, it raises before any stage runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline.main(["--stage", "all", "--synthetic",
                           "--data-dir", str(tmp_path / "ml"),
                           "--models-dir", str(tmp_path / "models")])
    assert not (tmp_path / "ml").exists()


def test_cli_data_stage_writes_the_files(tmp_path):
    cfg_env = {"SYNTH_USERS": "40", "SYNTH_ITEMS": "30", "SYNTH_RATINGS": "500"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_pipeline, "default_settings", Settings(**{
            k: int(v) for k, v in cfg_env.items()}))
        run_pipeline.main(["--stage", "data", "--synthetic", "--device", "cpu",
                           "--data-dir", str(tmp_path / "ml"),
                           "--models-dir", str(tmp_path / "models")])
    for f in ("ratings.dat", "users.dat", "movies.dat", "README"):
        assert (tmp_path / "ml" / f).exists()


def _offline(mp, url: str) -> None:
    """Both packages' ``MOVIELENS_1M_URL`` at ``url``, and no socket may
    connect."""
    import socket

    import recommendit_tpu.data.movielens as jml
    import recommendit_tpu_torch.data.movielens as tml

    def refuse(*args, **kwargs):
        raise AssertionError(f"a test tried to open a connection: {args}")

    mp.setattr(socket.socket, "connect", refuse)
    mp.setattr(socket, "create_connection", refuse)
    for mod in (jml, tml):
        mp.setattr(mod, "MOVIELENS_1M_URL", url)


def test_data_stage_without_synthetic_raises(tmp_path):
    """Without ``--synthetic`` and without the files, both packages' ``data``
    stage try the download (``download_movielens`` on the parent of
    ``data_dir``); from an address that answers nothing both raise JAX's
    ``RuntimeError``. ``tests/test_torch_download.py`` holds the download
    itself."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    missing = tmp_path / "no-such-ml-1m.zip"
    with pytest.MonkeyPatch.context() as mp:
        _offline(mp, missing.as_uri())
        for orch in (jrp.PipelineOrchestrator(cfg=JaxSettings(),
                                              data_dir=str(tmp_path / "jax" / "ml"),
                                              models_dir=str(tmp_path / "jax")),
                     PipelineOrchestrator(cfg=Settings(), data_dir=str(tmp_path / "ml"),
                                          models_dir=str(tmp_path), device="cpu")):
            with pytest.raises(RuntimeError, match="Cannot download MovieLens-1M") as err:
                orch.run_stage("data")
            assert str(missing) in str(err.value)
    assert not (tmp_path / "ml-1m").exists() and not (tmp_path / "jax" / "ml-1m").exists()


def test_data_stage_finds_files_placed_by_hand(tmp_path):
    """Files placed by hand in ``<parent>/ml-1m`` are found by both
    packages' ``data`` stage, which fetches nothing and leaves them as they
    are (the address a fetch would read answers nothing)."""
    import recommendit_tpu.pipelines.run_pipeline as jrp
    from recommendit_tpu_torch.data.movielens import save_movielens
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens

    save_movielens(make_synthetic_movielens(30, 20, 300, seed=2), str(tmp_path / "ml-1m"))
    before = {f.name: f.read_bytes() for f in (tmp_path / "ml-1m").iterdir()}
    orchs = {"jax": jrp.PipelineOrchestrator(cfg=JaxSettings(),
                                             data_dir=str(tmp_path / "ml-1m"),
                                             models_dir=str(tmp_path)),
             "port": PipelineOrchestrator(cfg=Settings(), data_dir=str(tmp_path / "ml-1m"),
                                          models_dir=str(tmp_path), device="cpu")}
    with pytest.MonkeyPatch.context() as mp:
        _offline(mp, (tmp_path / "gone.zip").as_uri())
        for orch in orchs.values():
            orch.run_stage("data")
            assert {f.name: f.read_bytes()
                    for f in (tmp_path / "ml-1m").iterdir()} == before
            assert "data" in orch.stage_times
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ml-1m"]


def test_embeddings_stage_refuses_what_is_not_ported(tmp_path):
    """``HOST_TABLE`` is ported (it trains: ``tests/test_torch_host_train.py``
    holds it to JAX); a JAX Orbax checkpoint directory is still refused."""
    small = dict(SYNTH_USERS=40, SYNTH_ITEMS=30, SYNTH_RATINGS=600)
    orch = PipelineOrchestrator(cfg=Settings(**small, HOST_TABLE=True, TRAIN_EPOCHS=1,
                                             HOST_TABLE_PREFETCH=0),
                                data_dir=str(tmp_path / "ht"), models_dir=str(tmp_path / "ht"),
                                synthetic=True, device="cpu")
    orch.run_stage("data")
    assert len(orch.run_embeddings()) == 1
    # an Orbax checkpoint directory (the JAX package's) is not read
    (tmp_path / "two_tower_ckpt" / "best").mkdir(parents=True)
    orch = PipelineOrchestrator(cfg=Settings(**small), data_dir=str(tmp_path / "ml"),
                                models_dir=str(tmp_path), synthetic=True, device="cpu")
    with pytest.raises(ValueError, match="Orbax"):
        orch.run_embeddings()


CUSTOM_RANKER = "elsewhere/ranker_variant.npz"


@pytest.mark.parametrize("respect", [False, True], ids=["remapped", "respected"])
def test_respect_cfg_paths_is_the_jax_rule(tmp_path, respect):
    """A ``RANKER_MODEL_PATH`` set away from its default is kept only with
    ``respect_cfg_paths=True``; the default paths go into models_dir either
    way, as in the JAX orchestrator."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    kw = dict(models_dir=str(tmp_path / "models"), data_dir=str(tmp_path / "ml"),
              respect_cfg_paths=respect)
    ours = PipelineOrchestrator(cfg=Settings(RANKER_MODEL_PATH=CUSTOM_RANKER),
                                device="cpu", **kw).cfg
    theirs = jrp.PipelineOrchestrator(
        cfg=JaxSettings(RANKER_MODEL_PATH=CUSTOM_RANKER), **kw).cfg
    keys = ("EMBEDDING_MODEL_PATH", "INDEX_PATH", "RANKER_MODEL_PATH", "DATA_DIR")
    assert [getattr(ours, k) for k in keys] == [getattr(theirs, k) for k in keys]
    assert (ours.RANKER_MODEL_PATH == CUSTOM_RANKER) is respect
    assert ours.EMBEDDING_MODEL_PATH == str(tmp_path / "models" / "two_tower.npz")


def test_embeddings_resume_false_trains_afresh_as_jax(tmp_path):
    """Beside a checkpoint of the last (best) epoch, ``resume=True`` takes
    no step and ``resume=False`` trains every epoch again, in both
    packages."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    small = dict(CFG, SYNTH_USERS=60, SYNTH_ITEMS=50, SYNTH_RATINGS=2_000,
                 TRAIN_EPOCHS=1)
    common = dict(data_dir=str(tmp_path / "ml"), synthetic=True)
    jorch = jrp.PipelineOrchestrator(cfg=JaxSettings(**small),
                                     models_dir=str(tmp_path / "jax"), **common)
    jorch.run_stage("data")
    ours = PipelineOrchestrator(cfg=Settings(**small),
                                models_dir=str(tmp_path / "port"), device="cpu",
                                **common)
    runs = {}
    for name, orch in (("jax", jorch), ("port", ours)):
        first = orch.run_embeddings()
        resumed = orch.run_embeddings()
        again = orch.run_embeddings(resume=False)
        runs[name] = [[h["epoch"] for h in hist] for hist in (first, resumed, again)]
        assert np.isfinite(again[0]["loss"]), name
    assert runs["port"] == runs["jax"] == [[1], [], [1]]


def test_cli_takes_log_level_as_jax(tmp_path):
    """``--log-level DEBUG`` parses and sets the logging level, in both
    CLIs."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    levels = {}
    small = {"SYNTH_USERS": 40, "SYNTH_ITEMS": 30, "SYNTH_RATINGS": 500}
    args = ["--stage", "data", "--synthetic", "--log-level", "DEBUG",
            "--models-dir", str(tmp_path / "models")]
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, cfg in (("jax", jrp, JaxSettings(**small)),
                               ("port", run_pipeline, Settings(**small))):
            mp.setattr(mod, "default_settings", cfg)
            mp.setattr(mod, "setup_logging",
                       lambda level, name=name: levels.__setitem__(name, level))
        jrp.main(args + ["--data-dir", str(tmp_path / "jax_ml")])
        run_pipeline.main(args + ["--data-dir", str(tmp_path / "ml"),
                                  "--device", "cpu"])
    assert levels == {"jax": "DEBUG", "port": "DEBUG"}
    assert (tmp_path / "ml" / "ratings.dat").exists()


def test_cli_reads_ranker_type_from_the_environment(tmp_path):
    """``RANKER_TYPE=gbdt`` (and the ``GBDT_*`` knobs) reach both CLIs'
    settings through ``Settings.from_env`` at import."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import recommendit_tpu.pipelines.run_pipeline as j, "
            "recommendit_tpu_torch.pipelines.run_pipeline as t\n"
            "for m in (j, t):\n"
            "    c = m.default_settings\n"
            "    print(c.RANKER_TYPE, c.GBDT_N_ESTIMATORS, c.GBDT_MAX_DEPTH)\n")
    env = dict(os.environ, RANKER_TYPE="gbdt", GBDT_N_ESTIMATORS="17",
               GBDT_MAX_DEPTH="4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["gbdt 17 4", "gbdt 17 4"]
