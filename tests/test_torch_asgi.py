"""The port's ASGI adapter (``serving/asgi.py``) and asyncio server
(``serving/asgi_server.py``), driven as ``tests/test_asgi.py`` drives the
JAX ones, over the JAX tests' mock pipeline behind the port's app; each
adapter case also against the JAX adapter, which must answer the same
status and payload (``latency_ms`` and ``uptime_seconds`` dropped). Every
socket call has a timeout, and the server thread is stopped in a
``finally``. Without a GPU, lifespan startup of an app that names no
device fails, and so does ``python -m
recommendit_tpu_torch.serving.asgi_server`` without ``--device``."""
import asyncio
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from recommendit_tpu.serving import asgi as jax_asgi
from recommendit_tpu.serving.app import RecommendItApp as JaxApp
from recommendit_tpu_torch.serving import asgi, asgi_server
from recommendit_tpu_torch.serving.app import RecommendItApp
from tests.test_api import make_mock_pipeline

TIMEOUT = 10
VOLATILE = ("latency_ms", "uptime_seconds")


def run_request(app, method, path, body=None, raw=None, chunks=None):
    sent = []
    if chunks is None:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else b"")
        chunks = [{"type": "http.request", "body": data, "more_body": False}]
    chunks = list(chunks)

    async def receive():
        return chunks.pop(0)

    async def send(msg):
        sent.append(msg)

    asyncio.run(app({"type": "http", "method": method, "path": path},
                    receive, send))
    status = next(m["status"] for m in sent if m["type"] == "http.response.start")
    headers = dict(next(m["headers"] for m in sent
                        if m["type"] == "http.response.start"))
    out = b"".join(m.get("body", b"") for m in sent
                   if m["type"] == "http.response.body")
    try:
        payload = json.loads(out)
    except json.JSONDecodeError:
        payload = out.decode()
    if isinstance(payload, dict):
        payload = {k: v for k, v in payload.items() if k not in VOLATILE}
    return status, payload, headers[b"content-type"]


@pytest.fixture
def pair():
    return (asgi.make_asgi_app(RecommendItApp(pipeline=make_mock_pipeline())),
            jax_asgi.make_asgi_app(JaxApp(pipeline=make_mock_pipeline())))


CASES = {
    "health": dict(method="GET", path="/health"),
    "recommend": dict(method="POST", path="/recommend", body={"user_id": 1, "k": 3}),
    "invalid_json": dict(method="POST", path="/recommend", raw=b"{nope"),
    "validation": dict(method="POST", path="/recommend", body={"user_id": -5}),
    "chunked_body": dict(method="POST", path="/recommend", chunks=[
        {"type": "http.request", "body": b'{"user_id": 2', "more_body": True},
        {"type": "http.request", "body": b', "k": 2}', "more_body": False}]),
    "model_info": dict(method="GET", path="/model/info"),
    "item": dict(method="GET", path="/items/101"),
    "not_found": dict(method="GET", path="/nope"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapter_answers_as_jax(pair, case):
    ours, theirs = (run_request(app, **CASES[case]) for app in pair)
    assert ours == theirs


def test_recommend_and_chunked_body(pair):
    status, body, _ = run_request(pair[0], **CASES["recommend"])
    assert status == 200 and len(body["recommendations"]) == 3
    status, body, _ = run_request(pair[0], **CASES["chunked_body"])
    assert status == 200 and len(body["recommendations"]) == 2
    assert run_request(pair[0], **CASES["invalid_json"])[0] == 422


def test_metrics_text(pair):
    status, body, ctype = run_request(pair[0], "GET", "/metrics")
    assert status == 200 and isinstance(body, str)
    assert "http_requests_total" in body and b"text/plain" in ctype


def _lifespan(app):
    msgs = [{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}]
    sent = []

    async def receive():
        return msgs.pop(0)

    async def send(m):
        sent.append(m)

    asyncio.run(app({"type": "lifespan"}, receive, send))
    return sent


def test_lifespan(pair):
    assert [m["type"] for m in _lifespan(pair[0])] == [
        "lifespan.startup.complete", "lifespan.shutdown.complete"]


def test_lifespan_without_a_card_fails(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    sent = _lifespan(asgi.make_asgi_app())
    assert [m["type"] for m in sent] == ["lifespan.startup.failed"]
    assert "needs an NVIDIA GPU" in sent[0]["message"]


def test_lifespan_on_the_cpu_creates_the_app(monkeypatch):
    made = []
    monkeypatch.setattr(asgi, "create_app",
                        lambda device: made.append(device) or RecommendItApp())
    sent = _lifespan(asgi.make_asgi_app(device="cpu"))
    assert made == ["cpu"]
    assert sent[0]["type"] == "lifespan.startup.complete"


def test_server_main_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    ran = []
    monkeypatch.setattr(asgi_server.ASGIServer, "run", lambda self: ran.append(self))
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        asgi_server.main(["--port", "0"])
    assert ran == []
    asgi_server.main(["--port", "0", "--device", "cpu"])
    assert len(ran) == 1


@pytest.fixture
def server():
    """The port's asyncio server on a free port in a thread, hosting the
    adapter over the mock pipeline."""
    app = asgi.make_asgi_app(RecommendItApp(pipeline=make_mock_pipeline()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = asgi_server.ASGIServer(app, "127.0.0.1", port, workers=8)
    loop = asyncio.new_event_loop()
    task = loop.create_task(srv.serve())

    def run():
        try:
            loop.run_until_complete(task)
        except asyncio.CancelledError:
            pass

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", port), 0.2):
                    break
            except OSError:
                time.sleep(0.05)
        yield f"http://127.0.0.1:{port}"
    finally:
        async def stop():
            await srv._shutdown_lifespan()
            task.cancel()

        asyncio.run_coroutine_threadsafe(stop(), loop).result(TIMEOUT)
        thread.join(timeout=TIMEOUT)
        loop.close()


def test_health_and_recommend_over_http(server):
    with urllib.request.urlopen(f"{server}/health", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert json.loads(r.read())["status"] == "healthy"
    req = urllib.request.Request(
        f"{server}/recommend", data=json.dumps({"user_id": 1, "k": 3}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert len(json.loads(r.read())["recommendations"]) == 3


def test_keep_alive_multiple_requests(server):
    conn = http.client.HTTPConnection(server.split("//")[1], timeout=TIMEOUT)
    try:
        for uid in (1, 2, 3):
            conn.request("POST", "/recommend",
                         body=json.dumps({"user_id": uid, "k": 2}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read())["user_id"] == uid
    finally:
        conn.close()


def test_validation_and_404_status(server):
    req = urllib.request.Request(
        f"{server}/recommend", data=json.dumps({"user_id": -5}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == 422
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=TIMEOUT)
    assert e.value.code == 404


def test_concurrent_clients(server):
    errs = []

    def hit(uid):
        try:
            req = urllib.request.Request(
                f"{server}/recommend",
                data=json.dumps({"user_id": uid, "k": 2}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                assert r.status == 200
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    ts = [threading.Thread(target=hit, args=(u + 1,)) for u in range(12)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT * 2)
    assert not errs
