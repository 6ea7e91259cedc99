"""HTTP load test against a running ``/recommend`` endpoint — torch port of
``scripts/load_test.py``.

Drives N concurrent client threads against a live server and reports
throughput and latency percentiles: the serving-side counterpart of
timing the device path alone.

Usage:
  # terminal 1: the port's server, on the card (add --device cpu for the CPU)
  MICRO_BATCH=true python -m recommendit_tpu_torch.serving.app
  # terminal 2
  python -m recommendit_tpu_torch.scripts.load_test --url http://localhost:8000 \
      --threads 16 --requests 2000 --max-user 1500
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://localhost:8000")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--max-user", type=int, default=1000)
    ap.add_argument("--use-cache", action="store_true")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    latencies: list = []
    errors = [0]
    lock = threading.Lock()
    counter = [0]

    def worker():
        local = []
        while True:
            with lock:
                if counter[0] >= args.requests:
                    break
                counter[0] += 1
            uid = int(rng.integers(1, args.max_user + 1))
            payload = json.dumps({
                "user_id": uid, "k": args.k, "use_cache": args.use_cache,
            }).encode()
            req = urllib.request.Request(
                f"{args.url}/recommend", data=payload,
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    resp.read()
                    if resp.status != 200:
                        errors[0] += 1
            except Exception:
                errors[0] += 1
            local.append((time.perf_counter() - t0) * 1000)
        with lock:
            latencies.extend(local)

    threads = [threading.Thread(target=worker) for _ in range(args.threads)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    lat = np.asarray(latencies)
    print(json.dumps({
        "requests": len(lat),
        "errors": errors[0],
        "threads": args.threads,
        "qps": round(len(lat) / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
    }))


if __name__ == "__main__":
    main()
