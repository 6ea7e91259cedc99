"""The port's HTTP app (``recommendit_tpu_torch/serving/app.py``) against the
JAX one.

1. Over the JAX tests' mock pipeline (``tests/test_api.py::
   make_mock_pipeline``) every request of ``tests/test_api.py`` goes through
   JAX's ``RecommendItApp`` and the port's: ``(status, payload, ctype)``
   identical, with ``latency_ms`` and ``uptime_seconds`` dropped, and the
   same calls made on the pipeline. ``/metrics`` is held to its status,
   content type and metric names (each package prints its own registry).
2. On shared saved artifacts (random weights: 200 users x 1,200 items, dim
   16, a fused f32 index, TOP_K_CANDIDATES=64, as in
   ``tests/test_torch_serving.py``) the JAX app and the port's app
   (``device="cpu"``): ``/recommend`` ids equal (near-ties may trade places)
   and scores within 1e-4; ``/recommend/batch`` equal; ``/model/info``'s
   ``index_stats`` equal; after the same ``POST /users|items/{id}/features``
   the next ``/recommend`` agrees again. With micro-batching at
   ``max_batch=8`` concurrent requests give ``serve_batch``'s lists (scores
   within 1e-4).
3. The device rule: ``create_app()`` and ``python -m
   recommendit_tpu_torch.serving.app`` without ``--device`` raise where
   there is no GPU; only a failed model load degrades.
4. A real ``ThreadingHTTPServer`` round trip on port 0, and the port's
   ``scripts/serve_bench.py`` (one level, 2 clients, 20 requests, against a
   server subprocess on the CPU) and ``scripts/load_test.py``. Every socket
   call has a timeout and every server is stopped in a ``finally``.
"""
import json
import logging
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.serving import app as jax_app
from recommendit_tpu.serving.batcher import QueueFullError as JaxQueueFull
from recommendit_tpu_torch.serving import app as port_app
from recommendit_tpu_torch.serving.batcher import QueueFullError as PortQueueFull
from tests.test_api import make_mock_pipeline
from tests.test_torch_serving import assert_same_ranking

ROOT = Path(__file__).resolve().parent.parent
VOLATILE = ("latency_ms", "uptime_seconds")
TIMEOUT = 10


def _strip(payload):
    if isinstance(payload, dict):
        return {k: v for k, v in payload.items() if k not in VOLATILE}
    return payload


# --- 1. the mock pipeline ---------------------------------------------- #

CACHED = [{"item_id": 7, "title": "C", "score": 0.5, "rank": 1,
           "retrieval_score": 0.4, "genres": []}]


def _cached(p, _):
    p.feature_store.get_cached_recommendations.return_value = CACHED


def _fails(p, _):
    p.get_recommendations.side_effect = RuntimeError("boom")


def _queue_full(p, queue_full):
    p.get_recommendations.side_effect = queue_full("full")


def _bulk(p, _):
    p.batch_recommend.side_effect = lambda uids, k: {
        u: list(range(100, 100 + k)) for u in uids}


def _update_fails(p, _):
    p.update_user_features.side_effect = RuntimeError("store down")


REQUESTS = {
    "health": ("GET", "/health", None, None),
    "health_degraded": ("GET", "/health", None, "unloaded"),
    "recommend_k5": ("POST", "/recommend", {"user_id": 1, "k": 5}, None),
    "recommend_k10": ("POST", "/recommend", {"user_id": 1, "k": 10}, None),
    "recommend_default_k": ("POST", "/recommend", {"user_id": 3}, None),
    "recommend_zero": ("POST", "/recommend", {"user_id": 0}, None),
    "recommend_negative": ("POST", "/recommend", {"user_id": -5}, None),
    "recommend_string": ("POST", "/recommend", {"user_id": "abc"}, None),
    "recommend_missing": ("POST", "/recommend", {"k": 10}, None),
    "recommend_k0": ("POST", "/recommend", {"user_id": 1, "k": 0}, None),
    "recommend_k101": ("POST", "/recommend", {"user_id": 1, "k": 101}, None),
    "recommend_bad_cache": ("POST", "/recommend",
                            {"user_id": 1, "use_cache": "yes"}, None),
    "recommend_not_object": ("POST", "/recommend", [1, 2], None),
    "recommend_unloaded": ("POST", "/recommend", {"user_id": 1}, "unloaded"),
    "recommend_cache_hit": ("POST", "/recommend", {"user_id": 1, "k": 1}, _cached),
    "recommend_cache_skipped": ("POST", "/recommend",
                                {"user_id": 1, "k": 1, "use_cache": False}, _cached),
    "recommend_popularity": ("POST", "/recommend", {"user_id": 1, "k": 3}, _fails),
    "recommend_429": ("POST", "/recommend", {"user_id": 1, "k": 3}, _queue_full),
    "model_info": ("GET", "/model/info", None, None),
    "model_info_unloaded": ("GET", "/model/info", None, "unloaded"),
    "batch": ("POST", "/recommend/batch", {"user_ids": [1, 2, 3], "k": 4}, _bulk),
    "batch_empty_body": ("POST", "/recommend/batch", {}, None),
    "batch_no_users": ("POST", "/recommend/batch", {"user_ids": []}, None),
    "batch_zero_user": ("POST", "/recommend/batch", {"user_ids": [0]}, None),
    "batch_string_user": ("POST", "/recommend/batch", {"user_ids": ["a"]}, None),
    "batch_k0": ("POST", "/recommend/batch", {"user_ids": [1], "k": 0}, None),
    "batch_k101": ("POST", "/recommend/batch", {"user_ids": [1], "k": 101}, None),
    "batch_unloaded": ("POST", "/recommend/batch", {"user_ids": [1]}, "unloaded"),
    "user_update": ("POST", "/users/7/features", {"avg_rating": 4.2}, None),
    "item_update": ("POST", "/items/9/features", {"popularity_score": 0.5}, None),
    "update_empty": ("POST", "/users/7/features", {}, None),
    "update_bad_id": ("POST", "/users/0/features", {"a": 1}, None),
    "update_unloaded": ("POST", "/users/7/features", {"a": 1}, "unloaded"),
    "update_fails": ("POST", "/users/7/features", {"a": 1}, _update_fails),
    "item_found": ("GET", "/items/101", None, None),
    "item_missing": ("GET", "/items/99999", None, None),
    "unknown_route": ("GET", "/nope", None, None),
}


def _run(module, queue_full, method, path, body, setup):
    pipe = None if setup == "unloaded" else make_mock_pipeline()
    if callable(setup):
        setup(pipe, queue_full)
    status, payload, ctype = module.RecommendItApp(pipeline=pipe).handle(
        method, path, body)
    return (status, _strip(payload), ctype), (pipe.mock_calls if pipe else None)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_mock_pipeline_payloads_are_the_jax_ones(case):
    args = REQUESTS[case]
    theirs, their_calls = _run(jax_app, JaxQueueFull, *args)
    ours, our_calls = _run(port_app, PortQueueFull, *args)
    assert ours == theirs
    assert our_calls == their_calls


def test_metrics_text_has_the_jax_names():
    names = ("http_requests_total", "request_latency_seconds_bucket",
             "active_requests", "recommendation_cache_misses_total")
    out = {}
    for name, module in (("jax", jax_app), ("port", port_app)):
        app = module.RecommendItApp(pipeline=make_mock_pipeline())
        app.handle("POST", "/recommend", {"user_id": 1, "k": 2})
        status, body, ctype = app.handle("GET", "/metrics")
        assert status == 200 and isinstance(body, str)
        assert all(n in body for n in names), name
        out[name] = ctype
    assert out["port"] == out["jax"] and "text/plain" in out["port"]


def test_port_metrics_live_in_their_own_registry():
    """Both middlewares are imported in this process without a duplicate
    timeseries, and the port's ``/metrics`` prints only its own
    collectors."""
    from prometheus_client import REGISTRY as DEFAULT

    from recommendit_tpu_torch.serving import middleware

    assert middleware.REGISTRY is not DEFAULT
    middleware.track_request("GET", "/items/5", lambda: (200, {}))
    text = middleware.generate_latest().decode()
    assert 'http_requests_total{endpoint="/items/{item_id}"' in text
    assert "python_gc_objects_collected_total" not in text
    with pytest.raises(ValueError):
        middleware.track_request("POST", "/recommend",
                                 lambda: (_ for _ in ()).throw(ValueError("x")))
    assert ('recommendation_errors_total{error_type="ValueError"}'
            in middleware.generate_latest().decode())


# --- 3. the device rule ------------------------------------------------ #

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def _missing(tmp_path, module):
    return module.Settings(
        EMBEDDING_MODEL_PATH=str(tmp_path / "missing.npz"),
        INDEX_PATH=str(tmp_path / "missing.index"),
        RANKER_MODEL_PATH=str(tmp_path / "missing.ranker"))


def test_create_app_degrades_on_a_failed_load_as_jax(tmp_path):
    from recommendit_tpu import config as jax_config
    from recommendit_tpu_torch import config

    theirs = jax_app.create_app(cfg=_missing(tmp_path, jax_config), load=True)
    ours = port_app.create_app(cfg=_missing(tmp_path, config), load=True,
                               device="cpu")
    assert ours.pipeline is None
    want = theirs.handle("GET", "/health")
    got = ours.handle("GET", "/health")
    assert (got[0], _strip(got[1]), got[2]) == (want[0], _strip(want[1]), want[2])
    assert got[1]["status"] == "degraded"


def test_create_app_without_a_card_raises(no_card, tmp_path):
    """Not degraded, not served from the CPU: the missing card raises
    before the load's tolerance, even where the load would fail too."""
    from recommendit_tpu_torch import config

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        port_app.create_app()
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        port_app.create_app(cfg=_missing(tmp_path, config))


def test_server_main_without_a_card_raises(no_card, monkeypatch):
    served = []
    monkeypatch.setattr(port_app, "HTTPServer",
                        lambda *a: served.append(a))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        port_app.main([])
    assert served == []


def test_entry_points_default_to_the_card():
    import inspect

    from recommendit_tpu_torch.scripts import serve_bench
    from recommendit_tpu_torch.serving import asgi

    for fn in (port_app.create_app, port_app.serve, asgi.make_asgi_app):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert port_app.main.__defaults__ == (None,)
    assert serve_bench.DEFAULT_DEVICE == "cuda"


# --- 4. a live server -------------------------------------------------- #

def _post(url, body, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def live_server():
    """The port's ``HTTPServer`` (a ``ThreadingHTTPServer`` with a longer
    listen backlog) on port 0 over the mock pipeline."""
    app = port_app.RecommendItApp(pipeline=make_mock_pipeline())
    server = port_app.HTTPServer(("127.0.0.1", 0), port_app.make_handler(app))
    assert server.request_queue_size == 1024
    server.timeout = TIMEOUT
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)


def test_http_round_trip(live_server):
    with urllib.request.urlopen(f"{live_server}/health", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert json.loads(r.read())["status"] == "healthy"
    status, body = _post(f"{live_server}/recommend", {"user_id": 2, "k": 3})
    assert status == 200 and len(body["recommendations"]) == 3
    req = urllib.request.Request(f"{live_server}/recommend", data=b"{not json",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == 422
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{live_server}/nope", timeout=TIMEOUT)
    assert e.value.code == 404


def test_load_test_script(live_server, capsys):
    from recommendit_tpu_torch.scripts import load_test

    load_test.main(["--url", live_server, "--threads", "2", "--requests", "20",
                    "--max-user", "50"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["requests"] == 20 and row["errors"] == 0 and row["qps"] > 0


@pytest.fixture(scope="module")
def small_artifacts(tmp_path_factory):
    """A random model, fused index and ranker (``chip_smoke.make_artifacts``
    at a small size) under ``<dir>/models``, and a synthetic dataset of the
    same size as ML-1M files."""
    import chip_smoke
    from recommendit_tpu_torch.data.movielens import save_movielens
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens

    tmp = tmp_path_factory.mktemp("bench")
    chip_smoke.make_artifacts(tmp / "models", seed=1, device="cpu", n_users=120,
                              n_items=600, dim=16, hidden=16, n_ratings=4000,
                              block_size=512)
    save_movielens(make_synthetic_movielens(120, 600, 4000, seed=3),
                   str(tmp / "ml"))
    return tmp


@pytest.mark.parametrize("variant", ["threaded", "asgi"])
def test_serve_bench_single_level(small_artifacts, tmp_path, variant):
    """One level of 2 closed-loop clients and 20 requests against the port's
    server started on the CPU, micro-batching on."""
    from recommendit_tpu_torch.scripts import serve_bench

    rows = serve_bench.main([
        "--artifacts", str(small_artifacts), "--data-dir",
        str(small_artifacts / "ml"), "--variant", variant, "--levels", "2",
        "--requests-per-client", "10", "--min-requests", "20",
        "--max-user", "120", "--device", "cpu", "--micro-batch",
        "--micro-batch-max", "8", "--startup-timeout", "120",
        "--log", str(tmp_path / "rows.jsonl")])
    assert len(rows) == 1
    row = rows[0]
    assert (row["clients"], row["requests"], row["ok"]) == (2, 20, 20), row
    assert row["codes"] == {"200": 20} and row["device"] == "cpu"
    assert json.loads((tmp_path / "rows.jsonl").read_text()) == row


# --- 2. shared artifacts ----------------------------------------------- #

N_USERS, N_ITEMS, DIM = 200, 1200, 16
USER_FEATS = {"avg_rating": 5.0, "log_rating_count": 8.0, "recency_score": 1.0,
              "gender_encoded": 1.0, "age_normalized": 1.0,
              "occupation_normalized": 1.0, "genre_pref": [1.0] * 9 + [0.0] * 9}
ITEM_FEATS = {"avg_rating": 1.0, "log_rating_count": 0.0, "popularity_score": 0.0,
              "genre_vector": [0.0] * 17 + [1.0]}


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """The JAX and the port's pipeline over the same saved artifacts, each
    behind its package's app."""
    from recommendit_tpu.config import Settings
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

    tmp = tmp_path_factory.mktemp("torch_app")
    rng = np.random.default_rng(11)
    data = make_synthetic_movielens(n_users=N_USERS, n_items=N_ITEMS,
                                    n_ratings=20_000, seed=5)
    model = TwoTowerModel(N_USERS, N_ITEMS, DIM, 32, seed=0)
    model.params["item_bias"] = jnp.asarray(rng.normal(size=N_ITEMS + 1), jnp.float32)
    model.save(str(tmp / "two_tower.npz"))
    item_ids = np.arange(1, N_ITEMS + 1)
    genres = build_genre_table(data.movies, N_ITEMS)[1:]
    index = MIPSIndex(DIM, mode="fused", dtype="float32")
    index.build(model.get_item_embeddings(item_ids, genres), item_ids,
                bias=0.05 * model.item_bias_np(item_ids))
    index.save(str(tmp / "mips.index.npz"))
    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(32, 16),
                              query_norm=False)
    ranker.params = init_mlp(jax.random.PRNGKey(1), len(names), (32, 16))
    ranker.feat_mean = rng.normal(size=len(names)).astype(np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker._trained = True
    ranker.save(str(tmp / "ranker.npz"))

    common = dict(EMBEDDING_DIM=DIM, INDEX_MODE="fused", INDEX_DTYPE="float32",
                  TOP_K_CANDIDATES=64, STAGE_RECAL_EVERY=0, FILTER_SEEN=True,
                  RANKER_BLEND_RETRIEVAL=1.0)
    paths = dict(model_path=str(tmp / "two_tower.npz"),
                 index_path=str(tmp / "mips.index.npz"),
                 ranker_path=str(tmp / "ranker.npz"),
                 features_dir=str(tmp / "features"),
                 redis_url="redis://localhost:9999", data_dir=str(tmp / "ml"))
    jp = JaxPipeline(cfg=Settings(**common), **paths)
    jp.load(data)   # writes the packed .npy snapshots the port reads
    from recommendit_tpu_torch.config import Settings as PortSettings

    port_paths = dict(paths, cfg=PortSettings(**common))
    tp = RecommendationPipeline(device="cpu", **port_paths)
    port_data = torch_synth(n_users=N_USERS, n_items=N_ITEMS, n_ratings=20_000,
                            seed=5)
    tp.load(port_data)
    return dict(jax=jax_app.RecommendItApp(pipeline=jp),
                port=port_app.RecommendItApp(pipeline=tp),
                paths=port_paths, data=port_data)


def _recs(app, user, k=20):
    status, body, _ = app.handle("POST", "/recommend",
                                 {"user_id": user, "k": k, "use_cache": False})
    assert status == 200 and body["cache_hit"] is False
    return body


def _assert_same_recs(got, want):
    assert set(got) == set(want)
    g, w = got["recommendations"], want["recommendations"]
    assert len(g) == len(w)
    assert_same_ranking([r["item_id"] for r in g], [r["score"] for r in g],
                        [r["item_id"] for r in w], [r["score"] for r in w])
    meta = {r["item_id"]: (r["title"], r["genres"]) for r in w}
    assert all(meta[r["item_id"]] == (r["title"], r["genres"]) for r in g)
    assert [r["rank"] for r in g] == [r["rank"] for r in w]


@pytest.mark.parametrize("user", [1, 23, 77, 150, 200, 10_000])
def test_recommend_agrees(apps, user):
    _assert_same_recs(_recs(apps["port"], user), _recs(apps["jax"], user))


def test_recommend_batch_equal(apps):
    body = {"user_ids": [3, 9, 55, 190, 10_000, 42], "k": 30}
    got = apps["port"].handle("POST", "/recommend/batch", body)
    want = apps["jax"].handle("POST", "/recommend/batch", body)
    assert (got[0], _strip(got[1])) == (want[0], _strip(want[1]))


def test_model_info_index_stats_equal(apps):
    got = apps["port"].handle("GET", "/model/info")[1]
    want = apps["jax"].handle("GET", "/model/info")[1]
    assert got["index_stats"] == want["index_stats"]
    assert got["index_stats"]["recall"] is None    # fused
    for key in ("model_version", "embedding_dim", "n_users", "n_items"):
        assert got[key] == want[key], key


def test_items_route_equal(apps):
    for item in (1, 600, N_ITEMS + 50):
        assert apps["port"].handle("GET", f"/items/{item}") == \
            apps["jax"].handle("GET", f"/items/{item}")


def test_user_feature_update_agrees(apps):
    """The same update through each app drops the user's cached list and
    changes their next list, alike in both."""
    user = 12
    before = _recs(apps["port"], user)
    for name in ("jax", "port"):
        app = apps[name]
        app.handle("POST", "/recommend", {"user_id": user, "k": 10})
        assert app.pipeline.feature_store.get_cached_recommendations(user)
        assert app.handle("POST", f"/users/{user}/features", USER_FEATS)[0] == 200
        assert app.pipeline.feature_store.get_cached_recommendations(user) is None
        assert app.pipeline.feature_store.get_user_features(user)["avg_rating"] == 5.0
    after = _recs(apps["port"], user)
    _assert_same_recs(after, _recs(apps["jax"], user))
    assert ([r["score"] for r in after["recommendations"]]
            != [r["score"] for r in before["recommendations"]])


def test_item_feature_update_agrees(apps):
    item, user = 77, 31
    for name in ("jax", "port"):
        assert apps[name].handle("POST", f"/items/{item}/features",
                                 ITEM_FEATS)[0] == 200
    _assert_same_recs(_recs(apps["port"], user), _recs(apps["jax"], user))
    row = apps["port"].pipeline._item_packed[item]
    assert row.shape == (64,) and float(row[0]) == 1.0


def test_queue_full_answers_429_as_jax(apps, monkeypatch):
    class Full:
        def __init__(self, err):
            self.err = err

        def submit(self, user_id, timeout=10.0):
            raise self.err("micro-batch queue at capacity (8)")

    monkeypatch.setattr(apps["jax"].pipeline, "_batcher", Full(JaxQueueFull))
    monkeypatch.setattr(apps["port"].pipeline, "_batcher", Full(PortQueueFull))
    body = {"user_id": 5, "k": 5, "use_cache": False}
    got = apps["port"].handle("POST", "/recommend", body)
    assert got == apps["jax"].handle("POST", "/recommend", body)
    assert got[0] == 429


def test_micro_batched_requests_match_serve_batch(apps, caplog):
    """16 concurrent requests through the app and a batcher of buckets of 8:
    the lists of ``serve_batch`` for the same users; the buckets warmed on
    the dispatch thread; no request answered from popularity."""
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    pipe = RecommendationPipeline(device="cpu", **apps["paths"])
    pipe.load(apps["data"])
    pipe.enable_micro_batching(max_batch=8, max_wait_ms=20)
    app = port_app.RecommendItApp(pipeline=pipe)
    users = list(range(101, 117))
    got = {}
    try:
        with caplog.at_level(logging.ERROR):
            threads = [threading.Thread(target=lambda u=u: got.__setitem__(
                u, _recs(app, u, k=30))) for u in users]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        stats = pipe.get_stats()["micro_batcher"]
    finally:
        pipe._batcher.close()
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert sorted(got) == users
    ids, scores, _ = (t.numpy() for t in pipe.serve_batch(users))
    for row, u in enumerate(users):
        recs = got[u]["recommendations"]
        fin = np.isfinite(scores[row])
        assert_same_ranking([r["item_id"] for r in recs],
                            [r["score"] for r in recs],
                            ids[row][fin][:30], scores[row][fin][:30])
    assert stats["requests_served"] == 16 and stats["batches_dispatched"] < 16
    assert stats["warm_thread"] != threading.current_thread().name
    assert stats["first_live_batch_ms"] > 0
