"""ASGI adapter for the framework-free router — torch port of
``recommendit_tpu/serving/asgi.py``.

Wraps the port's ``RecommendItApp`` (``serving/app.py``) in the ASGI 3.0
protocol (http and lifespan scopes), with no ASGI framework, so any ASGI
server can host it the way the reference serves its FastAPI app:

    uvicorn recommendit_tpu_torch.serving.asgi:app

or, without uvicorn, ``python -m recommendit_tpu_torch.serving.asgi_server``.
The module-level ``app`` loads its pipeline on the card at lifespan
startup; without one, startup fails (``lifespan.startup.failed``) rather
than serving a degraded app.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

from recommendit_tpu_torch.serving.app import RecommendItApp, create_app
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE


def make_asgi_app(app: Optional[RecommendItApp] = None,
                  device=DEFAULT_DEVICE) -> Callable:
    """Wrap a RecommendItApp (or lazily create one on ``device``) as an
    ASGI callable."""
    state = {"app": app}

    async def asgi(scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    if state["app"] is None:
                        try:
                            state["app"] = create_app(device=device)
                        except Exception as exc:  # no card: startup fails
                            await send({"type": "lifespan.startup.failed",
                                        "message": str(exc)})
                            return
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported scope {scope['type']}")
        if state["app"] is None:
            state["app"] = create_app(device=device)

        body = b""
        while True:
            msg = await receive()
            if msg["type"] == "http.request":
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            elif msg["type"] == "http.disconnect":
                return

        parsed: Any = None
        if body:
            try:
                parsed = json.loads(body)
            except json.JSONDecodeError:
                await _respond(send, 422, {
                    "detail": [{"loc": ["body"], "msg": "invalid JSON",
                                "type": "json_invalid"}]
                }, "application/json")
                return

        # the router core is synchronous (device calls, micro-batcher
        # waits) — run it on the loop's executor so one slow request never
        # stalls the event loop (the same contract uvicorn/Starlette give
        # sync endpoints)
        import asyncio

        loop = asyncio.get_running_loop()
        status, payload, ctype = await loop.run_in_executor(
            None, state["app"].handle, scope["method"], scope["path"], parsed
        )
        await _respond(send, status, payload, ctype)

    return asgi


async def _respond(send, status: int, payload, ctype: str):
    data = (payload.encode() if isinstance(payload, str)
            else json.dumps(payload).encode())
    await send({
        "type": "http.response.start",
        "status": status,
        "headers": [
            (b"content-type", ctype.encode()),
            (b"content-length", str(len(data)).encode()),
            (b"access-control-allow-origin", b"*"),
        ],
    })
    await send({"type": "http.response.body", "body": data})


# uvicorn entry point: `uvicorn recommendit_tpu_torch.serving.asgi:app`
app = make_asgi_app()
