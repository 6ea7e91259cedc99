"""Concurrent HTTP serving benchmark — torch port of ``scripts/serve_bench.py``.

Starts the port's server as a subprocess (the threaded standard-library
server, ``serving.app``, or the asyncio ASGI server, ``serving.asgi_server``)
with ``--device`` passed through, drives it with N concurrent closed-loop
clients at each concurrency level, and reports QPS and latency percentiles
per level. ``--overload`` then drives a micro-batcher with a small queue
past its capacity, to show 429 backpressure in place of an unbounded
latency tail.

    python -m recommendit_tpu_torch.scripts.serve_bench \\
        --artifacts runs/c4 --data-dir data/ml-1m --variant threaded \\
        --levels 1,16,64,256 [--micro-batch] [--overload] [--device cpu]

``--artifacts`` holds ``models/{two_tower,mips.index,ranker}.npz``, as the
pipeline CLI writes them. Prints one JSON line per level; with ``--log``
also appends them to that file.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import List

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULES = {"threaded": "recommendit_tpu_torch.serving.app",
           "asgi": "recommendit_tpu_torch.serving.asgi_server"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_server(proc: subprocess.Popen) -> None:
    """SIGTERM the server's process group and wait for it."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)


def start_server(args, port: int) -> subprocess.Popen:
    """The server on ``port``, once its ``/health`` reports the pipeline
    loaded. Its output goes to ``serve_bench_server_<port>.log`` in the
    temporary directory."""
    env = dict(os.environ)
    env.update(
        PYTHONPATH=REPO,
        EMBEDDING_MODEL_PATH=f"{args.artifacts}/models/two_tower.npz",
        INDEX_PATH=f"{args.artifacts}/models/mips.index.npz",
        RANKER_MODEL_PATH=f"{args.artifacts}/models/ranker.npz",
        DATA_DIR=args.data_dir,
        API_PORT=str(port),
        API_HOST="127.0.0.1",
        LOG_LEVEL="WARNING",
        MICRO_BATCH="true" if args.micro_batch else "false",
        MICRO_BATCH_MAX=str(args.micro_batch_max),
        MICRO_BATCH_WAIT_MS=str(args.micro_batch_wait_ms),
    )
    cmd = [sys.executable, "-m", MODULES[args.variant], "--device", args.device]
    log_path = os.path.join(tempfile.gettempdir(), f"serve_bench_server_{port}.log")
    with open(log_path, "wb") as slog:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=slog,
                                stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.time() + args.startup_timeout
    url = f"http://127.0.0.1:{port}/health"
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if json.loads(r.read()).get("pipeline_loaded"):
                    return proc
        except Exception:
            pass
        if proc.poll() is not None:
            with open(log_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(
                f"server exited early rc={proc.returncode}; {log_path}:\n{tail}")
        time.sleep(0.25)
    stop_server(proc)
    raise RuntimeError(f"server did not become healthy in time (log: {log_path})")


def run_level(url: str, threads: int, n_requests: int, k: int,
              max_user: int, use_cache: bool, timeout_s: float = 30.0):
    """``n_requests`` POST /recommend from ``threads`` closed-loop clients →
    QPS, status counts and latency percentiles (host ms)."""
    rng = np.random.default_rng(threads)
    uids = rng.integers(1, max_user + 1, size=n_requests).tolist()
    lat: list = []
    codes: dict = {}
    lock = threading.Lock()
    cursor = [0]

    def worker():
        local, lcodes = [], {}
        while True:
            with lock:
                i = cursor[0]
                if i >= n_requests:
                    break
                cursor[0] += 1
            payload = json.dumps(
                {"user_id": uids[i], "k": k, "use_cache": use_cache}).encode()
            req = urllib.request.Request(
                f"{url}/recommend", data=payload,
                headers={"Content-Type": "application/json"}, method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as r:
                    r.read()
                    code = r.status
            except urllib.error.HTTPError as e:
                e.read()
                code = e.code
            except Exception:
                code = -1
            local.append((time.perf_counter() - t0) * 1000)
            lcodes[code] = lcodes.get(code, 0) + 1
        with lock:
            lat.extend(local)
            for c, n in lcodes.items():
                codes[c] = codes.get(c, 0) + n

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    a = np.asarray(lat)
    return {
        "clients": threads,
        "requests": n_requests,
        "ok": codes.get(200, 0),
        "codes": {str(c): n for c, n in sorted(codes.items())},
        "qps": round(n_requests / wall, 1),
        "p50_ms": round(float(np.percentile(a, 50)), 2),
        "p95_ms": round(float(np.percentile(a, 95)), 2),
        "p99_ms": round(float(np.percentile(a, 99)), 2),
        "mean_ms": round(float(a.mean()), 2),
    }


def _emit(row: dict, log) -> None:
    print(json.dumps(row), flush=True)
    if log:
        with open(log, "a") as f:
            f.write(json.dumps(row) + "\n")


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", required=True,
                    help="dir holding models/{two_tower,mips.index,ranker}.npz")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--variant", choices=sorted(MODULES), default="threaded")
    ap.add_argument("--levels", default="1,16,64,256")
    ap.add_argument("--requests-per-client", type=int, default=40)
    ap.add_argument("--min-requests", type=int, default=200)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--max-user", type=int, default=1500)
    ap.add_argument("--use-cache", action="store_true")
    ap.add_argument("--micro-batch", action="store_true")
    ap.add_argument("--micro-batch-max", type=int, default=256)
    ap.add_argument("--micro-batch-wait-ms", type=float, default=2.0)
    ap.add_argument("--overload", action="store_true",
                    help="extra phase: saturate a tiny-queue micro-batcher "
                    "and report the 429 share")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the server's device (default: the card)")
    ap.add_argument("--startup-timeout", type=float, default=300.0)
    ap.add_argument("--log", default=None, help="append the JSON lines here")
    args = ap.parse_args(argv)

    rows = []
    port = free_port()
    proc = start_server(args, port)
    url = f"http://127.0.0.1:{port}"
    try:
        # one warm-up pass, unreported
        run_level(url, 8, 64, args.k, args.max_user, args.use_cache)
        for lvl in [int(x) for x in args.levels.split(",")]:
            n = max(args.min_requests, lvl * args.requests_per_client)
            row = run_level(url, lvl, n, args.k, args.max_user, args.use_cache)
            row.update(variant=args.variant, micro_batch=args.micro_batch,
                       device=args.device)
            rows.append(row)
            _emit(row, args.log)
    finally:
        stop_server(proc)

    if args.overload:
        # a small queue and a slow drain: submit() must shed with 429s,
        # and the accepted requests must stay fast (a bounded tail)
        o = argparse.Namespace(**vars(args))
        o.micro_batch = True
        o.micro_batch_max = 8
        o.micro_batch_wait_ms = 20.0
        port = free_port()
        proc = start_server(o, port)
        url = f"http://127.0.0.1:{port}"
        try:
            run_level(url, 8, 64, args.k, args.max_user, False)
            row = run_level(url, 256, 4096, args.k, args.max_user, False,
                            timeout_s=60.0)
            row.update(variant=args.variant, phase="overload", queue=8 * 8,
                       device=args.device)
            row["shed_429_share"] = round(row["codes"].get("429", 0)
                                          / row["requests"], 3)
            rows.append(row)
            _emit(row, args.log)
        finally:
            stop_server(proc)
    return rows


if __name__ == "__main__":
    main()
