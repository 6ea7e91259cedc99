"""The port's feature store against JAX's over a stand-in Redis client.

Neither machine has the ``redis`` package or a server, so a dict-backed
stand-in (:class:`FakeRedis`: the module's ``from_url`` and the client's
``ping``, ``get``, ``mget``, ``setex``, ``pipeline``, ``delete``,
``flushdb`` and ``info``, keeping each key's bytes and TTL) goes into both
store modules through ``monkeypatch``. The same calls through a JAX store
and a port store must leave byte-equal ``key -> (bytes, ttl)`` maps, with
msgpack on and off; each package reads the other's bytes; an unreachable
server leaves both on the in-memory backend. Tolerance: none — bytes,
TTLs and decoded values are equal, but for the served scores of
:func:`test_pipelines_cache_recommendations_alike`, which are held as
``tests/test_torch_serving.py`` holds them (1e-4).
"""
import dataclasses

import numpy as np
import pandas as pd
import pytest

from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.features import store as jstore
from recommendit_tpu.features.engineering import FeatureEngineer as JaxFE
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.features import store as pstore
from recommendit_tpu_torch.features.engineering import FeatureEngineer
from tests.test_torch_serving import assert_same_ranking, served  # noqa: F401

URL = "redis://redis:6379"
SYNTH = dict(n_users=70, n_items=60, n_ratings=2500, seed=4)
USER_UPDATE = {"avg_rating": np.float32(4.25), "rating_count": np.int64(12),
               "log_rating_count": 2.5649, "gender_encoded": 1,
               "genre_pref": np.linspace(0.0, 1.0, 18, dtype=np.float32)}
ITEM_UPDATE = {"title": "Amélie (2001)", "avg_rating": 3.0,
               "genre_vector": np.eye(18, dtype=np.float32)[4]}
RECS = [{"item_id": 3, "title": "Café (1990)", "score": 0.5, "rank": 1,
         "retrieval_score": 0.25, "genres": ["Drama", "Comedy"]},
        {"item_id": 9, "title": "", "score": float("-inf"), "rank": 2,
         "retrieval_score": 0.0, "genres": []}]
CODEC_CASES = [
    {},
    {"a": 1, "b": 2.5, "c": "x", "d": None, "e": True},
    {"vec": np.arange(5, dtype=np.float32) / 3, "n": np.int32(7), "f": np.float64(0.1)},
    {"recs": RECS},
    {"nested": {"k": [1, [2.0, "z"]]}, "nan": float("nan")},
]


class _Pipeline:
    def __init__(self, client):
        self.client, self.queued = client, []

    def setex(self, key, ttl, value):
        self.queued.append((key, ttl, value))
        return self

    def execute(self):
        for key, ttl, value in self.queued:
            self.client.setex(key, ttl, value)
        self.client.executed.append(len(self.queued))
        return [True] * len(self.queued)


class FakeRedis:
    """Stand-in for the ``redis`` module and its client (``from_url``
    returns the stand-in itself); ``up=False`` makes ``ping`` fail as an
    unreachable server does."""

    def __init__(self, up: bool = True):
        self.up = up
        self.data = {}          # key -> (bytes, ttl)
        self.connects = []      # from_url's (url, keywords)
        self.executed = []      # commands a pipeline ran, per execute()

    def from_url(self, url, **kw):
        self.connects.append((url, kw))
        return self

    def ping(self):
        if not self.up:
            raise ConnectionError("Error 111 connecting to redis:6379. Connection refused.")
        return True

    def get(self, key):
        hit = self.data.get(key)
        return None if hit is None else hit[0]

    def mget(self, keys):
        return [self.get(k) for k in keys]

    def setex(self, key, ttl, value):
        assert isinstance(value, bytes) and isinstance(ttl, int)
        self.data[key] = (value, ttl)
        return True

    def pipeline(self):
        return _Pipeline(self)

    def delete(self, key):
        return int(self.data.pop(key, None) is not None)

    def flushdb(self):
        self.data.clear()
        return True

    def info(self, section):
        assert section == "keyspace"
        # a real server leaves out an empty db
        return {"db0": {"keys": len(self.data), "expires": len(self.data)}} if self.data else {}


def _install(monkeypatch, module, fake, msgpack_on: bool) -> None:
    monkeypatch.setattr(module, "redis", fake)
    monkeypatch.setattr(module, "REDIS_AVAILABLE", fake is not None)
    monkeypatch.setattr(module, "MSGPACK_AVAILABLE", msgpack_on)


@pytest.fixture(params=[True, False], ids=["msgpack", "json"])
def msgpack_on(request):
    return request.param


@pytest.fixture
def fakes(monkeypatch, msgpack_on):
    """(JAX's stand-in, the port's stand-in), installed."""
    fj, fp = FakeRedis(), FakeRedis()
    _install(monkeypatch, jstore, fj, msgpack_on)
    _install(monkeypatch, pstore, fp, msgpack_on)
    return fj, fp


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The same features as each package's pipeline hands them to
    ``load_all_features``: JAX's parquet frames, the port's npz columns."""
    tmp = tmp_path_factory.mktemp("store_frames")
    jfe, tfe = JaxFE(seed=0), FeatureEngineer(seed=0)
    jfe.set_data(jax_synth(**SYNTH))
    tfe.set_data(make_synthetic_movielens(**SYNTH))
    for fe, out in ((jfe, tmp / "jax"), (tfe, tmp / "port")):
        fe.build_user_features()
        fe.build_item_features()
        fe.save_features(str(out))
    jax_frames = [pd.read_parquet(tmp / "jax" / f"{t}_features.parquet")
                  for t in ("user", "item")]
    port_frames = []
    for t in ("user", "item"):
        with np.load(tmp / "port" / f"{t}_features.npz") as z:
            port_frames.append({c: z[c] for c in z.files})
    return jax_frames, port_frames


def _drive(store, users, items) -> dict:
    """One sequence of store calls → what the reads returned."""
    store.load_all_features(users, items, batch_size=32)
    out = {}
    store.store_user_features(7, USER_UPDATE)
    out["user"] = store.get_user_features(7)
    out["user_loaded"] = store.get_user_features(3)
    store.store_item_features(3, ITEM_UPDATE)
    out["item"] = store.get_item_features(3)
    out["item_missing"] = store.get_item_features(10_000)
    out["batch"] = store.get_item_features_batch([1, 2, 3, 10_000])
    store.cache_recommendations(5, RECS)
    store.cache_recommendations(6, RECS[:1], ttl=60)
    out["recs"] = store.get_cached_recommendations(5)
    store.invalidate_recommendations(6)
    out["recs_dropped"] = store.get_cached_recommendations(6)
    out["stats"] = store.stats()
    return out


@pytest.mark.parametrize("case", CODEC_CASES, ids=range(len(CODEC_CASES)))
def test_codec_bytes_equal_jax(monkeypatch, msgpack_on, case):
    for module in (jstore, pstore):
        monkeypatch.setattr(module, "MSGPACK_AVAILABLE", msgpack_on)
    raw = pstore.serialize(case)
    assert raw == jstore.serialize(case)
    if msgpack_on:
        assert raw == jstore.msgpack.packb(
            {k: jstore._to_native(v) for k, v in case.items()}, use_bin_type=True)
    got, want = pstore.deserialize(raw), jstore.deserialize(raw)
    # NaN != NaN: compare the decoded values by their bytes again
    assert pstore.serialize(got) == jstore.serialize(want)


@pytest.mark.parametrize("writer_msgpack", [True, False], ids=["msgpack", "json"])
def test_a_msgpack_reader_takes_either_format(monkeypatch, writer_msgpack):
    """A reader with msgpack takes JSON too (a producer without msgpack), in
    both packages, whichever package wrote."""
    for writer, reader in ((jstore, pstore), (pstore, jstore)):
        monkeypatch.setattr(writer, "MSGPACK_AVAILABLE", writer_msgpack)
        monkeypatch.setattr(reader, "MSGPACK_AVAILABLE", True)
        raw = writer.serialize({"recs": RECS, "v": np.float32(0.5)})
        assert reader.deserialize(raw) == {"recs": RECS, "v": 0.5}


def test_same_calls_leave_byte_equal_keys(fakes, frames, msgpack_on):
    fj, fp = fakes
    (ju, ji), (pu, pi) = frames
    js, ps = jstore.FeatureStore(URL), pstore.FeatureStore(URL)
    assert js.is_redis_available and ps.is_redis_available
    assert fj.connects == fp.connects == [(URL, {"socket_connect_timeout": 2})]
    got, want = _drive(ps, pu, pi), _drive(js, ju, ji)
    assert got == want
    assert got["user"]["genre_pref"] == USER_UPDATE["genre_pref"].tolist()
    assert got["recs"] == RECS and got["recs_dropped"] is None
    assert got["stats"] == {"backend": "redis", "url": URL, "keys": len(fj.data)}
    assert fp.data == fj.data
    # every user and item row, the two updated, one cached list; bulk loads
    # in one pipeline a batch of 32
    assert fp.data.keys() == ({f"user:feat:{u}" for u in pu["user_id"]}
                              | {f"item:feat:{i}" for i in pi["item_id"]}
                              | {"user:feat:7", "item:feat:3", "recs:5"})
    assert fp.executed == fj.executed and max(fp.executed) == 32
    ttls = {k: ttl for k, (_, ttl) in fp.data.items()}
    assert ttls.pop("recs:5") == 300 and set(ttls.values()) == {3600}
    raw = fp.data["user:feat:7"][0]
    assert raw[:1] == (b"\x85" if msgpack_on else b"{")
    ps.flush()
    js.flush()
    assert fp.data == fj.data == {}
    assert ps.stats() == js.stats() == {"backend": "redis", "url": URL, "keys": 0}


def test_each_package_reads_the_others_keys(monkeypatch, frames, msgpack_on):
    """One stand-in shared: what either store writes, the other reads as
    the writer reads it."""
    shared = FakeRedis()
    _install(monkeypatch, jstore, shared, msgpack_on)
    _install(monkeypatch, pstore, shared, msgpack_on)
    (ju, ji), (pu, pi) = frames
    js, ps = jstore.FeatureStore(URL), pstore.FeatureStore(URL)
    js.load_all_features(ju, ji)
    users = list(range(0, SYNTH["n_users"] + 2))
    from_jax = [js.get_user_features(u) for u in users]
    assert [ps.get_user_features(u) for u in users] == from_jax
    assert sum(f is not None for f in from_jax) > 50
    items = list(range(0, SYNTH["n_items"] + 2))
    assert ps.get_item_features_batch(items) == js.get_item_features_batch(items)
    js.flush()
    ps.load_all_features(pu, pi)
    assert [js.get_user_features(u) for u in users] == from_jax
    ps.store_user_features(7, USER_UPDATE)
    ps.cache_recommendations(5, RECS)
    assert js.get_user_features(7) == ps.get_user_features(7)
    assert js.get_cached_recommendations(5) == RECS
    js.invalidate_recommendations(5)
    assert ps.get_cached_recommendations(5) is None


@pytest.mark.parametrize("installed", [True, False], ids=["unreachable", "no_package"])
def test_both_fall_back_to_memory(monkeypatch, caplog, installed):
    fakes = [FakeRedis(up=False) if installed else None for _ in range(2)]
    _install(monkeypatch, jstore, fakes[0], True)
    _install(monkeypatch, pstore, fakes[1], True)
    with caplog.at_level("WARNING"):
        stores = [jstore.FeatureStore(URL), pstore.FeatureStore(URL)]
    for store in stores:
        assert not store.is_redis_available
        assert store.stats() == {"backend": "in-memory", "keys": 0}
        store.cache_recommendations(5, RECS)
        assert store.get_cached_recommendations(5) == RECS
    want = "Redis unreachable" if installed else "redis package unavailable"
    warned = [r for r in caplog.records if want in r.getMessage()]
    assert [r.name for r in warned] == [jstore.__name__, pstore.__name__]
    if installed:
        assert all(f.connects == [(URL, {"socket_connect_timeout": 2})] for f in fakes)


def test_redis_feature_store_alias():
    from recommendit_tpu.features import RedisFeatureStore as JaxAlias
    from recommendit_tpu_torch.features import RedisFeatureStore

    assert RedisFeatureStore is pstore.FeatureStore
    assert JaxAlias is jstore.FeatureStore


@pytest.mark.parametrize("served", [False], indirect=True, ids=["plain_ranker"])
def test_pipelines_cache_recommendations_alike(monkeypatch, served, msgpack_on):
    """A CPU pipeline over a Redis-backed store writes ``recs:{id}`` with
    ttl 300 as JAX's does; a feature update writes the user's key with the
    feature TTL and drops the cached list; a list the port cached is what
    JAX's pipeline answers from the cache."""
    jp, tp, _, _ = served
    fj, fp = FakeRedis(), FakeRedis()
    _install(monkeypatch, jstore, fj, msgpack_on)
    _install(monkeypatch, pstore, fp, msgpack_on)
    monkeypatch.setattr(jp, "feature_store", jstore.FeatureStore(URL, ttl=3600))
    monkeypatch.setattr(tp, "feature_store", pstore.FeatureStore(URL, ttl=3600))
    users = [1, 42, 131]
    first = {u: (jp.get_recommendations(u, k=10), tp.get_recommendations(u, k=10))
             for u in users}
    assert fp.data.keys() == fj.data.keys() == {f"recs:{u}" for u in users}
    for u, (jr, tr) in first.items():
        (jraw, jttl), (praw, pttl) = fj.data[f"recs:{u}"], fp.data[f"recs:{u}"]
        assert jttl == pttl == 300
        jrecs, precs = jstore.deserialize(jraw)["recs"], pstore.deserialize(praw)["recs"]
        assert [list(r) for r in precs] == [list(r) for r in jrecs]
        assert precs == [dataclasses.asdict(r) for r in tr]
        assert_same_ranking([r["item_id"] for r in precs], [r["score"] for r in precs],
                            [r["item_id"] for r in jrecs], [r["score"] for r in jrecs])
    hits = tp.get_stats()["cache_hits"]
    assert tp.get_recommendations(42, k=10) == first[42][1]
    assert tp.get_stats()["cache_hits"] == hits + 1

    feats = {"avg_rating": 2.5, "genre_pref": [0.0] * 18}
    jp.update_user_features(42, feats)
    tp.update_user_features(42, feats)
    assert fp.data.keys() == fj.data.keys() == {"recs:1", "recs:131", "user:feat:42"}
    assert fp.data["user:feat:42"] == fj.data["user:feat:42"]
    assert fp.data["user:feat:42"][1] == 3600

    # JAX's pipeline answers from the list the port cached
    monkeypatch.setattr(jp.feature_store, "_backend", tp.feature_store._backend)
    jhits = jp.get_stats()["cache_hits"]
    got = jp.get_recommendations(131, k=10)
    assert jp.get_stats()["cache_hits"] == jhits + 1
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r)
                                                    for r in first[131][1]]
