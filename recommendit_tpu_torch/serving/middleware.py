"""Prometheus metrics — torch port of ``recommendit_tpu/serving/middleware.py``.

The same collector names, labels and buckets as the JAX middleware (and the
reference's, ``src/serving/middleware.py:17-72``), so the dashboards in
``monitoring/`` read either server. The port's collectors live in a
registry of their own, :data:`REGISTRY`, which ``/metrics`` prints: the JAX
middleware registers the same names in prometheus_client's default
registry, and one process may import both packages.

Without prometheus_client the collectors are no-ops, as in the JAX module.
"""
from __future__ import annotations

import time
from typing import Callable

try:
    from prometheus_client import (
        CONTENT_TYPE_LATEST,
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest as _generate_latest,
    )

    PROMETHEUS_AVAILABLE = True
    REGISTRY = CollectorRegistry()

    def generate_latest() -> bytes:
        return _generate_latest(REGISTRY)

except ImportError:  # pragma: no cover
    PROMETHEUS_AVAILABLE = False
    CONTENT_TYPE_LATEST = "text/plain"
    REGISTRY = None

    class _Noop:
        def labels(self, **kw):
            return self

        def observe(self, *a):
            pass

        def inc(self, *a):
            pass

        def dec(self, *a):
            pass

        def set(self, *a):
            pass

    def Counter(*a, **k):  # type: ignore
        return _Noop()

    Gauge = Histogram = Counter  # type: ignore

    def generate_latest() -> bytes:  # type: ignore
        return b"# prometheus_client unavailable\n"


REQUEST_LATENCY = Histogram(
    "request_latency_seconds",
    "HTTP request latency in seconds",
    ["method", "endpoint", "status_code"],
    buckets=[0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0,
             2.5, 5.0],
    registry=REGISTRY,
)
RECOMMENDATION_LATENCY_MS = Histogram(
    "recommendation_latency_ms",
    "End-to-end recommendation pipeline latency in milliseconds",
    buckets=[5, 10, 25, 50, 75, 100, 200, 500, 1000, 2000, 5000],
    registry=REGISTRY,
)
RETRIEVAL_LATENCY_MS = Histogram(
    "retrieval_latency_ms",
    "MIPS retrieval latency in milliseconds",
    buckets=[1, 2, 5, 10, 20, 50, 100, 200],
    registry=REGISTRY,
)
RANKING_LATENCY_MS = Histogram(
    "ranking_latency_ms",
    "Re-ranking latency in milliseconds",
    buckets=[1, 2, 5, 10, 20, 50, 100, 200],
    registry=REGISTRY,
)
CANDIDATES_RETRIEVED = Gauge(
    "candidates_retrieved_total",
    "Number of candidates retrieved per request",
    registry=REGISTRY,
)
CACHE_HITS = Counter(
    "recommendation_cache_hits_total",
    "Total number of recommendation cache hits",
    registry=REGISTRY,
)
CACHE_MISSES = Counter(
    "recommendation_cache_misses_total",
    "Total number of recommendation cache misses",
    registry=REGISTRY,
)
REQUESTS_TOTAL = Counter(
    "http_requests_total",
    "Total number of HTTP requests",
    ["method", "endpoint", "status_code"],
    registry=REGISTRY,
)
ACTIVE_REQUESTS = Gauge(
    "active_requests",
    "Number of currently active HTTP requests",
    registry=REGISTRY,
)
RECOMMENDATION_ERRORS = Counter(
    "recommendation_errors_total",
    "Total number of recommendation errors",
    ["error_type"],
    registry=REGISTRY,
)


def normalize_endpoint(path: str) -> str:
    """Bound label cardinality (reference ``middleware.py:113-126``)."""
    if path.startswith("/recommend"):
        return "/recommend"
    if path.startswith("/health"):
        return "/health"
    if path.startswith("/metrics"):
        return "/metrics"
    if path.startswith("/model"):
        return "/model/info"
    if path.startswith("/items"):
        return "/items/{item_id}"
    return path


def track_request(method: str, path: str, handler: Callable):
    """Run a request handler under the reference middleware's metrics
    (active gauge, latency histogram, totals, per-error counter)."""
    endpoint = normalize_endpoint(path)
    ACTIVE_REQUESTS.inc()
    t0 = time.perf_counter()
    try:
        status, body = handler()
    except Exception as exc:
        RECOMMENDATION_ERRORS.labels(error_type=type(exc).__name__).inc()
        raise
    finally:
        ACTIVE_REQUESTS.dec()
    latency = time.perf_counter() - t0
    labels = dict(method=method, endpoint=endpoint, status_code=str(status))
    REQUEST_LATENCY.labels(**labels).observe(latency)
    REQUESTS_TOTAL.labels(**labels).inc()
    return status, body


def record_recommendation_metrics(
    latency_ms: float,
    retrieval_ms: float,
    ranking_ms: float,
    n_candidates: int,
    cache_hit: bool,
) -> None:
    RECOMMENDATION_LATENCY_MS.observe(latency_ms)
    RETRIEVAL_LATENCY_MS.observe(retrieval_ms)
    RANKING_LATENCY_MS.observe(ranking_ms)
    CANDIDATES_RETRIEVED.set(n_candidates)
    if cache_hit:
        CACHE_HITS.inc()
    else:
        CACHE_MISSES.inc()
