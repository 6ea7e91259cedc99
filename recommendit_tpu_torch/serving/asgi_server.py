"""Minimal asyncio HTTP/1.1 server hosting an ASGI 3.0 application — torch
port of ``recommendit_tpu/serving/asgi_server.py``.

The reference serves its app with ``uvicorn --workers 2``; this module
gives the same topology — an asyncio event loop accepting keep-alive
connections, the app's synchronous core on a thread executor — without
uvicorn. It speaks the part of HTTP/1.1 the recommendation API needs:
request line and headers, Content-Length bodies, keep-alive, JSON
responses.

    python -m recommendit_tpu_torch.serving.asgi_server [--device cpu]
    python -m recommendit_tpu_torch.serving.asgi_server --port 9000 --workers 128

Protocol coverage: ASGI lifespan (startup/shutdown) and http scopes, one
``http.request`` message per request (bodies are read fully before
dispatch), ``http.response.start`` / ``http.response.body`` without
streaming. Chunked request bodies are answered with 411 (Length
Required).
"""
from __future__ import annotations

import asyncio
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

logger = logging.getLogger(__name__)

_MAX_HEADER = 64 * 1024
_MAX_BODY = 16 * 1024 * 1024


class ASGIServer:
    def __init__(
        self,
        app: Callable,
        host: str = "0.0.0.0",
        port: int = 8000,
        workers: int = 128,
    ):
        self.app = app
        self.host = host
        self.port = port
        # the executor bounds in-flight synchronous handler calls; it must
        # comfortably exceed the expected client concurrency or requests
        # queue behind the pool instead of the micro-batcher
        self.workers = workers
        self._server: Optional[asyncio.AbstractServer] = None
        self._lifespan_queue: Optional[asyncio.Queue] = None

    # --- lifespan -------------------------------------------------------- #

    async def _run_lifespan(self) -> None:
        self._lifespan_queue = asyncio.Queue()
        started = asyncio.get_running_loop().create_future()

        async def receive():
            return await self._lifespan_queue.get()

        async def send(msg):
            if msg["type"] == "lifespan.startup.complete" and not started.done():
                started.set_result(True)
            elif msg["type"] == "lifespan.startup.failed" and not started.done():
                started.set_exception(
                    RuntimeError(msg.get("message", "lifespan startup failed"))
                )

        task = asyncio.ensure_future(
            self.app({"type": "lifespan", "asgi": {"version": "3.0"}},
                     receive, send)
        )
        await self._lifespan_queue.put({"type": "lifespan.startup"})
        try:
            await asyncio.wait_for(started, timeout=600)
        except asyncio.TimeoutError:
            logger.warning("lifespan startup did not complete; continuing")
        self._lifespan_task = task

    async def _shutdown_lifespan(self) -> None:
        if self._lifespan_queue is not None:
            await self._lifespan_queue.put({"type": "lifespan.shutdown"})
            try:
                await asyncio.wait_for(self._lifespan_task, timeout=10)
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                pass

    # --- connection handling ---------------------------------------------- #

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                keep = await self._handle_one(reader, writer)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        except Exception:  # noqa: BLE001 — connection-level guard
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _handle_one(self, reader, writer) -> bool:
        """Serve one request; returns True to keep the connection alive."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as exc:
            if exc.partial:
                raise
            return False  # clean EOF between requests
        except asyncio.LimitOverrunError:
            await self._plain(writer, 431, b"header too large")
            return False
        if len(head) > _MAX_HEADER:
            await self._plain(writer, 431, b"header too large")
            return False

        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            await self._plain(writer, 400, b"bad request line")
            return False
        headers = []
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers.append((k.strip().lower().encode("latin-1"),
                            v.strip().encode("latin-1")))
        hmap = dict(headers)

        if b"chunked" in hmap.get(b"transfer-encoding", b""):
            await self._plain(writer, 411, b"length required")
            return False
        length = int(hmap.get(b"content-length", b"0") or 0)
        if length > _MAX_BODY:
            await self._plain(writer, 413, b"body too large")
            return False
        body = await reader.readexactly(length) if length else b""

        path, _, query = target.partition("?")
        keep_alive = (
            version.endswith("1.1")
            and hmap.get(b"connection", b"").lower() != b"close"
        ) or hmap.get(b"connection", b"").lower() == b"keep-alive"

        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": method.upper(),
            "scheme": "http",
            "path": path,
            "raw_path": target.encode("latin-1"),
            "query_string": query.encode("latin-1"),
            "root_path": "",
            "headers": headers,
            "client": writer.get_extra_info("peername"),
            "server": (self.host, self.port),
        }

        sent_body = False

        async def receive():
            nonlocal body
            b, body = body, b""
            return {"type": "http.request", "body": b, "more_body": False}

        async def send(msg):
            nonlocal sent_body
            if msg["type"] == "http.response.start":
                status = msg["status"]
                hdrs = list(msg.get("headers", []))
                hdrs.append((b"connection",
                             b"keep-alive" if keep_alive else b"close"))
                out = [f"HTTP/1.1 {status} {_REASON.get(status, '')}"
                       .encode("latin-1")]
                out += [k + b": " + v for k, v in hdrs]
                writer.write(b"\r\n".join(out) + b"\r\n\r\n")
            elif msg["type"] == "http.response.body":
                writer.write(msg.get("body", b""))
                if not msg.get("more_body"):
                    sent_body = True
                await writer.drain()

        try:
            await self.app(scope, receive, send)
        except Exception:  # noqa: BLE001 — app-level guard
            logger.exception("ASGI app error on %s %s", method, path)
            if not sent_body:
                await self._plain(writer, 500, b'{"detail": "internal error"}',
                                  ctype=b"application/json")
            return False
        return keep_alive and sent_body

    @staticmethod
    async def _plain(writer, status: int, body: bytes,
                     ctype: bytes = b"text/plain") -> None:
        writer.write(
            b"HTTP/1.1 %d %s\r\ncontent-type: %s\r\ncontent-length: %d\r\n"
            b"connection: close\r\n\r\n%s"
            % (status, _REASON.get(status, "").encode(), ctype, len(body),
               body)
        )
        await writer.drain()

    # --- lifecycle --------------------------------------------------------- #

    async def serve(self) -> None:
        loop = asyncio.get_running_loop()
        loop.set_default_executor(ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="asgi-worker"
        ))
        await self._run_lifespan()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=_MAX_HEADER
        )
        logger.info("ASGI server on %s:%d (%d workers)",
                    self.host, self.port, self.workers)
        async with self._server:
            await self._server.serve_forever()

    def run(self) -> None:
        try:
            asyncio.run(self.serve())
        except KeyboardInterrupt:
            pass


_REASON = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 411: "Length Required",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def main(argv=None):
    import argparse

    from recommendit_tpu_torch.config import settings
    from recommendit_tpu_torch.serving.asgi import make_asgi_app
    from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

    ap = argparse.ArgumentParser(description="asyncio ASGI server")
    ap.add_argument("--host", default=settings.API_HOST)
    ap.add_argument("--port", type=int, default=settings.API_PORT)
    ap.add_argument("--workers", type=int, default=128)
    ap.add_argument("--log-level", default=settings.LOG_LEVEL)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))
    device = resolve_device(args.device)
    ASGIServer(make_asgi_app(device=device), args.host, args.port,
               args.workers).run()


if __name__ == "__main__":
    main()
