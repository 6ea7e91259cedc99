"""Online feature store — the part the serve path touches (torch port).

Counterpart of ``recommendit_tpu/features/store.py``: the in-memory
key-value backend and the recommendation cache under the same ``recs:``
key contract. Values are stored serialized (JSON), as the JAX store does
when msgpack is absent, so a cached list is a copy and not shared with the
caller. The Redis backend and the feature keys are not ported yet
(ROADMAP).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

RECS_PREFIX = "recs:"


def serialize(data: Dict[str, Any]) -> bytes:
    return json.dumps(data).encode("utf-8")


def deserialize(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode("utf-8"))


class MemoryBackend:
    """Plain-dict KV backend (TTLs are ignored: process lifetime is the TTL)."""

    def __init__(self) -> None:
        self._kv: Dict[str, bytes] = {}

    def read(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def write(self, key: str, value: bytes, ttl: int) -> None:
        self._kv[key] = value

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)


class FeatureStore:
    """Recommendation cache over the in-memory backend."""

    def __init__(self):
        self._backend = MemoryBackend()

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
