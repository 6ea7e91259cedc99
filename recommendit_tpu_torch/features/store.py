"""Online feature store (torch port).

Counterpart of ``recommendit_tpu/features/store.py``: the key contract
``user:feat:{id}`` / ``item:feat:{id}`` / ``recs:{id}``, the wire format
(msgpack where the package is importable, else JSON; a msgpack reader also
takes JSON), TTLs through SETEX, the bulk load of the flattened feature
columns (the port's column dicts in place of DataFrames) in one pipeline a
batch, the recommendation cache and the read-through to a memory-mapped
:class:`~recommendit_tpu_torch.features.snapshot.FeatureSnapshot`.

The backend is chosen once, at construction, as JAX's store chooses it:
Redis at ``redis_url`` where the ``redis`` package is importable and the
server answers, else the in-memory one. For the same calls the port writes
the JAX store's bytes under the same keys with the same TTLs
(``tests/test_torch_store_redis.py``), so a JAX pipeline and a port server
read each other's keys in one Redis.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

try:
    import redis  # type: ignore
except ImportError:  # pragma: no cover
    redis = None

try:
    import msgpack  # type: ignore
except ImportError:  # pragma: no cover
    msgpack = None

REDIS_AVAILABLE = redis is not None
MSGPACK_AVAILABLE = msgpack is not None

logger = logging.getLogger(__name__)

USER_FEATURE_PREFIX = "user:feat:"
ITEM_FEATURE_PREFIX = "item:feat:"
RECS_PREFIX = "recs:"


# --- serialization ---------------------------------------------------------- #

def _to_native(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _json_pack(clean: Dict[str, Any]) -> bytes:
    return json.dumps(clean).encode("utf-8")


def _json_unpack(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode("utf-8"))


def _msgpack_pack(clean: Dict[str, Any]) -> bytes:
    return msgpack.packb(clean, use_bin_type=True)


def _msgpack_unpack(data: bytes) -> Dict[str, Any]:
    try:
        return msgpack.unpackb(data, raw=False)
    except Exception:
        # a JSON payload written by a producer without msgpack
        return _json_unpack(data)


def serialize(data: Dict[str, Any]) -> bytes:
    """msgpack if available, else JSON. ``MSGPACK_AVAILABLE`` is read per
    call, so tests can switch it."""
    clean = {k: _to_native(v) for k, v in data.items()}
    pack = _msgpack_pack if MSGPACK_AVAILABLE else _json_pack
    return pack(clean)


def deserialize(data: bytes) -> Dict[str, Any]:
    unpack = _msgpack_unpack if MSGPACK_AVAILABLE else _json_unpack
    return unpack(data)


# --- backends ---------------------------------------------------------------- #

class _MemoryBackend:
    """Plain-dict KV backend (TTLs are ignored: process lifetime is the TTL)."""

    name = "in-memory"

    def __init__(self) -> None:
        self._kv: Dict[str, bytes] = {}

    def read(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def read_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return [self._kv.get(k) for k in keys]

    def write(self, key: str, value: bytes, ttl: int) -> None:
        self._kv[key] = value

    def write_many(self, items: Dict[str, bytes], ttl: int) -> None:
        self._kv.update(items)

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)

    def flush(self) -> None:
        self._kv.clear()

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name, "keys": len(self._kv)}


class _RedisBackend:
    """Redis KV backend. Construction raises when the server does not
    answer; the store catches that and falls back to memory."""

    name = "redis"

    def __init__(self, url: str) -> None:
        self.url = url
        self._r = redis.from_url(url, socket_connect_timeout=2)
        self._r.ping()

    def read(self, key: str) -> Optional[bytes]:
        return self._r.get(key)

    def read_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return self._r.mget(keys)

    def write(self, key: str, value: bytes, ttl: int) -> None:
        self._r.setex(key, ttl, value)

    def write_many(self, items: Dict[str, bytes], ttl: int) -> None:
        pipe = self._r.pipeline()
        for k, v in items.items():
            pipe.setex(k, ttl, v)
        pipe.execute()

    def delete(self, key: str) -> None:
        self._r.delete(key)

    def flush(self) -> None:
        self._r.flushdb()

    def stats(self) -> Dict[str, Any]:
        db = self._r.info("keyspace").get("db0", {})
        return {"backend": self.name, "url": self.url, "keys": db.get("keys", 0)}


def _pick_backend(redis_url: str):
    if not REDIS_AVAILABLE:
        logger.warning("redis package unavailable; using in-memory store")
        return _MemoryBackend()
    try:
        backend = _RedisBackend(redis_url)
        logger.info("Connected to Redis at %s", redis_url)
        return backend
    except Exception as exc:
        logger.warning("Redis unreachable (%s); using in-memory store", exc)
        return _MemoryBackend()


class FeatureStore:
    """Feature keys and the recommendation cache over the backend
    :func:`_pick_backend` chose, with an optional snapshot to fall through
    to."""

    def __init__(self, redis_url: str = "redis://localhost:6379", ttl: int = 3600):
        self.redis_url = redis_url
        self.ttl = ttl
        self._backend = _pick_backend(redis_url)
        self._snapshot = None

    @property
    def is_redis_available(self) -> bool:
        return isinstance(self._backend, _RedisBackend)

    # --- user and item features --------------------------------------- #

    def store_user_features(self, user_id: int, features: Dict[str, Any]) -> None:
        self._backend.write(f"{USER_FEATURE_PREFIX}{user_id}", serialize(features),
                            self.ttl)

    def get_user_features(self, user_id: int) -> Optional[Dict[str, Any]]:
        raw = self._backend.read(f"{USER_FEATURE_PREFIX}{user_id}")
        if raw is not None:
            return deserialize(raw)
        if self._snapshot is not None:
            return self._snapshot.user_dict(user_id)
        return None

    def store_item_features(self, item_id: int, features: Dict[str, Any]) -> None:
        self._backend.write(f"{ITEM_FEATURE_PREFIX}{item_id}", serialize(features),
                            self.ttl)

    def get_item_features(self, item_id: int) -> Optional[Dict[str, Any]]:
        raw = self._backend.read(f"{ITEM_FEATURE_PREFIX}{item_id}")
        if raw is not None:
            return deserialize(raw)
        if self._snapshot is not None:
            return self._snapshot.item_dict(item_id)
        return None

    def get_item_features_batch(self, item_ids: List[int]
                                ) -> Dict[int, Optional[Dict[str, Any]]]:
        raws = self._backend.read_many([f"{ITEM_FEATURE_PREFIX}{i}" for i in item_ids])
        out = {i: (deserialize(r) if r is not None else None)
               for i, r in zip(item_ids, raws)}
        if self._snapshot is not None:
            for i in item_ids:
                if out[i] is None:
                    out[i] = self._snapshot.item_dict(i)
        return out

    def attach_snapshot(self, snapshot) -> None:
        """Back the store with a read-only snapshot: reads that miss the KV
        layer fall through to it; writes land in the KV layer and shadow
        it."""
        self._snapshot = snapshot

    # --- bulk load ----------------------------------------------------- #

    def load_all_features(self, user_features: Mapping[str, np.ndarray],
                          item_features: Mapping[str, np.ndarray],
                          batch_size: int = 500) -> None:
        """Bulk-load the flattened feature columns (``genre_pref_<i>`` /
        ``genre_vec_<i>``, as ``features/engineering.py`` saves them): one
        dict per user and item, the genre columns as a ``genre_pref`` /
        ``genre_vector`` list, item titles as strings."""
        logger.info("Loading features: %d users, %d items",
                    len(user_features["user_id"]), len(item_features["item_id"]))
        self._bulk_load(user_features, "user_id", USER_FEATURE_PREFIX,
                        "genre_pref_", "genre_pref", ("user_id",), batch_size)
        self._bulk_load(item_features, "item_id", ITEM_FEATURE_PREFIX,
                        "genre_vec_", "genre_vector", ("item_id", "title"),
                        batch_size, keep_as_str=("title",))
        logger.info("Bulk load complete")

    def _bulk_load(self, frame: Mapping[str, np.ndarray], key_col: str, prefix: str,
                   vec_prefix: str, vec_name: str, drop: Tuple[str, ...],
                   batch_size: int, keep_as_str: Iterable[str] = ()) -> None:
        vec_cols = [c for c in frame if c.startswith(vec_prefix)]
        scalar_cols = [c for c in frame if c not in drop and c not in vec_cols]
        str_cols = [c for c in keep_as_str if c in frame]
        # Python scalars, as DataFrame.to_dict("records") gives them
        scalars = {c: np.asarray(frame[c]).tolist() for c in scalar_cols}
        strs = {c: [str(v) for v in np.asarray(frame[c]).tolist()] for c in str_cols}
        vecs = (np.stack([np.asarray(frame[c]) for c in vec_cols], axis=1).astype(float).tolist()
                if vec_cols else None)
        keys = np.asarray(frame[key_col]).astype(np.int64).tolist()
        for start in range(0, len(keys), batch_size):
            items: Dict[str, bytes] = {}
            for r in range(start, min(start + batch_size, len(keys))):
                feat: Dict[str, Any] = {c: scalars[c][r] for c in scalar_cols}
                for c in str_cols:
                    feat[c] = strs[c][r]
                if vecs is not None:
                    feat[vec_name] = vecs[r]
                items[f"{prefix}{keys[r]}"] = serialize(feat)
            self._backend.write_many(items, self.ttl)

    # --- recommendation cache ----------------------------------------- #

    def cache_recommendations(self, user_id: int, recommendations: List[Dict],
                              ttl: int = 300) -> None:
        self._backend.write(f"{RECS_PREFIX}{user_id}",
                            serialize({"recs": recommendations}), ttl)

    def invalidate_recommendations(self, user_id: int) -> None:
        """Drop a user's cached recommendations."""
        self._backend.delete(f"{RECS_PREFIX}{user_id}")

    def get_cached_recommendations(self, user_id: int) -> Optional[List[Dict]]:
        raw = self._backend.read(f"{RECS_PREFIX}{user_id}")
        if raw is None:
            return None
        return deserialize(raw).get("recs")

    # --- ops ----------------------------------------------------------- #

    def flush(self) -> None:
        self._backend.flush()

    def stats(self) -> Dict[str, Any]:
        return self._backend.stats()


# JAX's alias of the reference's class name
RedisFeatureStore = FeatureStore
