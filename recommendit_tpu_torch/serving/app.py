"""HTTP serving surface — torch port of ``recommendit_tpu/serving/app.py``.

The same routes, request and response schemas, status codes and
degradation as the JAX app (and the reference FastAPI app,
``src/serving/app.py``): ``POST /recommend`` (422 on validation, 503
without a pipeline, the cache fast path, 429 when the micro-batcher's
queue is full, popularity on any other pipeline failure),
``POST /recommend/batch``, ``GET /health``, ``GET /metrics``,
``GET /model/info``, ``GET /items/{item_id}`` and
``POST /users|items/{id}/features``. The core is a framework-free
``handle(method, path, body) → (status, payload, content_type)`` router,
served here by the standard library's threaded HTTP server and by
``serving/asgi.py`` under any ASGI server.

The pipeline runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``): :func:`create_app` resolves the device before it
loads, so a missing card raises, and only a failed model load leaves the
app degraded.

    python -m recommendit_tpu_torch.serving.app [--device cpu]
"""
from __future__ import annotations

import json
import logging
import re
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.serving import middleware
from recommendit_tpu_torch.serving.batcher import QueueFullError
from recommendit_tpu_torch.serving.middleware import (
    CONTENT_TYPE_LATEST,
    record_recommendation_metrics,
    track_request,
)
from recommendit_tpu_torch.serving.recommender import RecommendationPipeline
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)

_ITEM_RE = re.compile(r"^/items/(-?\d+)$")
_FEAT_RE = re.compile(r"^/(users|items)/(-?\d+)/features$")


class ValidationError(Exception):
    def __init__(self, errors):
        self.errors = errors
        super().__init__(str(errors))


def _validate_recommend_request(body: Any) -> Dict[str, Any]:
    """Mirror the reference's pydantic constraints
    (``app.py:30-33``: user_id int > 0, 1 <= k <= 100, use_cache bool)."""
    errors = []
    if not isinstance(body, dict):
        raise ValidationError(
            [{"loc": ["body"], "msg": "expected JSON object", "type": "type_error"}]
        )
    user_id = body.get("user_id")
    if user_id is None:
        errors.append({"loc": ["body", "user_id"], "msg": "field required",
                       "type": "missing"})
    elif not isinstance(user_id, int) or isinstance(user_id, bool):
        errors.append({"loc": ["body", "user_id"], "msg": "value is not a valid integer",
                       "type": "int_parsing"})
    elif user_id <= 0:
        errors.append({"loc": ["body", "user_id"],
                       "msg": "Input should be greater than 0",
                       "type": "greater_than"})

    k = body.get("k", 20)
    if not isinstance(k, int) or isinstance(k, bool):
        errors.append({"loc": ["body", "k"], "msg": "value is not a valid integer",
                       "type": "int_parsing"})
    elif not (1 <= k <= 100):
        errors.append({"loc": ["body", "k"],
                       "msg": "Input should be between 1 and 100",
                       "type": "range"})

    use_cache = body.get("use_cache", True)
    if not isinstance(use_cache, bool):
        errors.append({"loc": ["body", "use_cache"],
                       "msg": "value is not a valid boolean",
                       "type": "bool_parsing"})
    if errors:
        raise ValidationError(errors)
    return {"user_id": user_id, "k": k, "use_cache": use_cache}


class RecommendItApp:
    """Framework-free request router with the reference's API contract."""

    def __init__(
        self,
        pipeline: Optional[RecommendationPipeline] = None,
        cfg: Optional[Settings] = None,
    ):
        self.cfg = cfg or default_settings
        self.pipeline = pipeline
        self.startup_time = time.time()

    # --- route handlers ------------------------------------------------ #

    def health(self) -> Tuple[int, Dict]:
        uptime = round(time.time() - self.startup_time, 2)
        if self.pipeline is not None and self.pipeline._loaded:
            fs = self.pipeline.feature_store.stats()
            return 200, {
                "status": "healthy",
                "pipeline_loaded": True,
                "feature_store_backend": fs.get("backend", "unknown"),
                "model_version": self.cfg.MODEL_VERSION,
                "uptime_seconds": uptime,
            }
        return 200, {
            "status": "degraded",
            "pipeline_loaded": False,
            "feature_store_backend": "none",
            "model_version": self.cfg.MODEL_VERSION,
            "uptime_seconds": uptime,
        }

    def recommend(self, body: Any) -> Tuple[int, Dict]:
        if self.pipeline is None or not self.pipeline._loaded:
            return 503, {"detail": "Recommendation pipeline not available"}
        req = _validate_recommend_request(body)
        t0 = time.perf_counter()

        if req["use_cache"]:
            cached = self.pipeline.feature_store.get_cached_recommendations(
                req["user_id"]
            )
            if cached is not None:
                latency_ms = (time.perf_counter() - t0) * 1000
                record_recommendation_metrics(
                    latency_ms=latency_ms, retrieval_ms=0.0, ranking_ms=0.0,
                    n_candidates=0, cache_hit=True,
                )
                return 200, {
                    "user_id": req["user_id"],
                    "recommendations": cached[: req["k"]],
                    "latency_ms": round(latency_ms, 2),
                    "cache_hit": True,
                    "n_candidates": 0,
                }

        try:
            # use_cache=True lets the pipeline POPULATE the rec cache (the
            # reference passes False here, app.py:180, which means its HTTP
            # path never fills the cache it checks — fixed by design here;
            # the redundant inner cache get is a dict lookup).
            results = self.pipeline.get_recommendations(
                user_id=req["user_id"], k=req["k"], use_cache=req["use_cache"]
            )
        except QueueFullError:
            # micro-batcher backpressure → shed load
            return 429, {
                "detail": "Server overloaded — retry shortly",
                "retry_after_ms": 50,
            }
        except Exception:
            logger.exception("Recommendation error for user %d", req["user_id"])
            results = self.pipeline._popularity_recommendations(req["k"])

        latency_ms = (time.perf_counter() - t0) * 1000
        record_recommendation_metrics(
            latency_ms=latency_ms,
            retrieval_ms=self.pipeline.retrieval_latency.p50,
            ranking_ms=self.pipeline.ranking_latency.p50,
            n_candidates=self.pipeline.top_k_candidates,
            cache_hit=False,
        )
        return 200, {
            "user_id": req["user_id"],
            "recommendations": [
                {
                    "item_id": r.item_id,
                    "title": r.title,
                    "score": round(r.score, 6),
                    "rank": r.rank,
                    "retrieval_score": round(r.retrieval_score, 6),
                    "genres": r.genres,
                }
                for r in results
            ],
            "latency_ms": round(latency_ms, 2),
            "cache_hit": False,
            "n_candidates": self.pipeline.top_k_candidates,
        }

    def model_info(self) -> Tuple[int, Dict]:
        if self.pipeline is None or not self.pipeline._loaded:
            return 503, {"detail": "Pipeline not loaded"}
        p = self.pipeline
        return 200, {
            "model_version": self.cfg.MODEL_VERSION,
            "embedding_dim": p.model.embed_dim,
            "n_users": p.model.n_users,
            "n_items": p.model.n_items,
            "index_stats": p.index.stats(),
            "ranker_info": p.ranker.model_info(),
            "pipeline_stats": p.get_stats(),
        }

    def recommend_batch(self, body: Any) -> Tuple[int, Dict]:
        """Bulk recommendation (additive route): {"user_ids": [...], "k": n}
        → ranked item-id lists per user via the batched device path."""
        if self.pipeline is None or not self.pipeline._loaded:
            return 503, {"detail": "Recommendation pipeline not available"}
        if not isinstance(body, dict):
            return 422, {"detail": [{"loc": ["body"], "msg": "expected JSON object",
                                     "type": "type_error"}]}
        user_ids = body.get("user_ids")
        k = body.get("k", self.cfg.TOP_K_RESULTS)
        if (not isinstance(user_ids, list) or not user_ids
                or len(user_ids) > 4096
                or not all(isinstance(u, int) and not isinstance(u, bool)
                           and u > 0 for u in user_ids)):
            return 422, {"detail": [{"loc": ["body", "user_ids"],
                                     "msg": "expected 1-4096 positive ints",
                                     "type": "value_error"}]}
        if not isinstance(k, int) or isinstance(k, bool) or not 1 <= k <= 100:
            return 422, {"detail": [{"loc": ["body", "k"],
                                     "msg": "Input should be between 1 and 100",
                                     "type": "range"}]}
        t0 = time.perf_counter()
        recs = self.pipeline.batch_recommend(user_ids, k=k)
        return 200, {
            "recommendations": {str(u): recs[u] for u in user_ids},
            "latency_ms": round((time.perf_counter() - t0) * 1000, 2),
            "n_users": len(user_ids),
        }

    def update_features(self, kind: str, entity_id: int,
                        body: Any) -> Tuple[int, Dict]:
        """Online feature update (additive route beyond the reference —
        its store is only writable offline): POST /users/{id}/features or
        /items/{id}/features with a feature dict body."""
        if self.pipeline is None or not self.pipeline._loaded:
            return 503, {"detail": "Pipeline not loaded"}
        if not isinstance(body, dict) or not body:
            return 422, {"detail": [{"loc": ["body"],
                                     "msg": "expected non-empty feature object",
                                     "type": "type_error"}]}
        if entity_id <= 0:
            return 422, {"detail": [{"loc": ["path", "id"],
                                     "msg": "Input should be greater than 0",
                                     "type": "greater_than"}]}
        try:
            if kind == "user":
                self.pipeline.update_user_features(entity_id, body)
            else:
                self.pipeline.update_item_features(entity_id, body)
        except Exception:
            logger.exception("Feature update failed for %s %d", kind, entity_id)
            return 500, {"detail": "feature update failed"}
        return 200, {"status": "updated", "kind": kind, "id": entity_id}

    def item(self, item_id: int) -> Tuple[int, Dict]:
        if self.pipeline is None or not self.pipeline._loaded:
            return 503, {"detail": "Pipeline not loaded"}
        title = self.pipeline._item_titles.get(item_id)
        if title is None:
            return 404, {"detail": f"Item {item_id} not found"}
        return 200, {
            "item_id": item_id,
            "title": title,
            "genres": self.pipeline._item_genres.get(item_id, []),
        }

    # --- router --------------------------------------------------------- #

    def handle(
        self, method: str, path: str, body: Any = None
    ) -> Tuple[int, Any, str]:
        """Route a request → (status, payload, content_type)."""

        def dispatch() -> Tuple[int, Any]:
            if method == "GET" and path == "/health":
                return self.health()
            if method == "POST" and path == "/recommend":
                try:
                    return self.recommend(body)
                except ValidationError as ve:
                    return 422, {"detail": ve.errors}
            if method == "POST" and path == "/recommend/batch":
                return self.recommend_batch(body)
            if method == "GET" and path == "/metrics":
                return 200, middleware.generate_latest().decode("utf-8")
            if method == "GET" and path == "/model/info":
                return self.model_info()
            m = _ITEM_RE.match(path)
            if method == "GET" and m:
                return self.item(int(m.group(1)))
            m = _FEAT_RE.match(path)
            if method == "POST" and m:
                kind = "user" if m.group(1) == "users" else "item"
                return self.update_features(kind, int(m.group(2)), body)
            return 404, {"detail": "Not Found"}

        status, payload = track_request(method, path, dispatch)
        ctype = (
            CONTENT_TYPE_LATEST if path == "/metrics" and status == 200
            else "application/json"
        )
        return status, payload, ctype


def create_app(
    pipeline: Optional[RecommendationPipeline] = None,
    cfg: Optional[Settings] = None,
    load: bool = True,
    device=DEFAULT_DEVICE,
) -> RecommendItApp:
    """App factory with the reference's degraded-startup tolerance
    (``app.py:78-92``): a pipeline load failure leaves a serving app whose
    /health reports degraded instead of crashing. The device is resolved
    first, outside that tolerance: without a card, a call that names no
    device raises."""
    cfg = cfg or default_settings
    if pipeline is None and load:
        device = resolve_device(device)
        try:
            pipeline = RecommendationPipeline(cfg=cfg, device=device)
            pipeline.load()
            if cfg.MICRO_BATCH:
                pipeline.enable_micro_batching(
                    cfg.MICRO_BATCH_MAX, cfg.MICRO_BATCH_WAIT_MS
                )
        except Exception as exc:
            logger.error("Failed to load pipeline: %s", exc)
            pipeline = None
    return RecommendItApp(pipeline=pipeline, cfg=cfg)


# ------------------------------------------------------------------ #
# stdlib HTTP server                                                    #
# ------------------------------------------------------------------ #

class HTTPServer(ThreadingHTTPServer):
    """The standard library's threaded server with a listen backlog for
    many clients at once. Its default backlog is 5: past it the kernel
    drops new connections, which the clients retry a second later, so
    hundreds of concurrent clients would see second-long stalls."""

    request_queue_size = 1024


def make_handler(app: RecommendItApp):
    class Handler(BaseHTTPRequestHandler):
        def _respond(self, status: int, payload: Any, ctype: str):
            data = (
                payload.encode() if isinstance(payload, str)
                else json.dumps(payload).encode()
            )
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            status, payload, ctype = app.handle("GET", self.path)
            self._respond(status, payload, ctype)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b"{}"
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                self._respond(
                    422,
                    {"detail": [{"loc": ["body"], "msg": "invalid JSON",
                                 "type": "json_invalid"}]},
                    "application/json",
                )
                return
            status, payload, ctype = app.handle("POST", self.path, body)
            self._respond(status, payload, ctype)

        def log_message(self, fmt, *args):
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


def serve(app: Optional[RecommendItApp] = None, host: Optional[str] = None,
          port: Optional[int] = None, device=DEFAULT_DEVICE) -> None:
    cfg = default_settings
    app = app or create_app(cfg=cfg, device=device)
    host = host or cfg.API_HOST
    port = port or cfg.API_PORT
    server = HTTPServer((host, port), make_handler(app))
    logger.info("Serving on %s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="recommendit_tpu_torch HTTP server")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=getattr(logging, default_settings.LOG_LEVEL))
    serve(device=args.device)


if __name__ == "__main__":
    main()
