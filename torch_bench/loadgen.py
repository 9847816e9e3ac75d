"""Open-loop load for the inpainting service, in a process of its own.

    python3 torch_bench/loadgen.py --url http://127.0.0.1:PORT --bodies b.jsonl \\
        --rate 40 --seconds 20 --seed 7 --samples s.npz

Reads pre-encoded /inpaint bodies (one JSON body a line), warms the
service with a few requests, prints ``ready`` and waits for ``go`` on
standard input. Then it sends requests at Poisson arrival times drawn
from the seed, each on a pool thread, whether or not earlier ones have
finished. A request's latency runs from its due time to its full
response, so a late send counts against it; a failed request's is
infinite. After the last due time it waits for the answers, at most a
minute, decodes the sampled ones with the benchmark's codec, and prints
one JSON line of results.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path
from urllib.parse import urlparse

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_bench import codec, traffic  # noqa: E402

LATE_WAIT_S = 60.0


def post(host: str, port: int, body: bytes, timeout: float):
    """(status, response body) of one /inpaint request on its own connection."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/inpaint", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--url", required=True)
    p.add_argument("--bodies", required=True)
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--samples", required=True)
    p.add_argument("--sample-share", type=float, default=0.05)
    p.add_argument("--sample-max", type=int, default=24)
    p.add_argument("--workers", type=int, default=128)
    args = p.parse_args(argv)
    u = urlparse(args.url)
    host, port = u.hostname, u.port
    bodies = [line.encode() for line in Path(args.bodies).read_text().splitlines()]
    due = traffic.poisson_schedule(args.rate, args.seconds, args.seed)
    rng = np.random.default_rng([args.seed % 2**63, 5])
    payload = rng.permutation(len(due)) % len(bodies)  # each body as often, in the seed's order
    sampled = set(np.flatnonzero(rng.random(len(due)) < args.sample_share)[: args.sample_max])
    pool = ThreadPoolExecutor(args.workers)

    # warm-up: one request at a time, then a burst that fills a batch
    statuses = [post(host, port, bodies[i % len(bodies)], 120)[0] for i in range(4)]
    statuses += [s for s, _ in pool.map(
        lambda i: post(host, port, bodies[i % len(bodies)], 120), range(16))]
    if set(statuses) != {200}:
        raise RuntimeError(f"the service failed its warm-up requests: {statuses}")
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 2

    n = len(due)
    latency = np.full(n, np.inf)
    lateness = np.zeros(n)
    answers = {}
    lock = threading.Lock()

    def send(i: int, t_due: float) -> None:
        t_sent = time.perf_counter()
        try:
            status, data = post(host, port, bodies[payload[i]], LATE_WAIT_S)
        except (OSError, http.client.HTTPException):
            status, data = None, b""
        t_done = time.perf_counter()
        with lock:
            lateness[i] = t_sent - t_due
            if status == 200:
                latency[i] = t_done - t_due
                if i in sampled:
                    answers[i] = data

    t0 = time.perf_counter()
    futures = []
    for i, t in enumerate(due):
        t_due = t0 + t
        delay = t_due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(pool.submit(send, i, t_due))
    t_close = time.perf_counter()
    done, _ = wait(futures, timeout=max(0.0, t0 + args.seconds + LATE_WAIT_S - time.perf_counter()))
    t_end = time.perf_counter()
    for f in done:
        f.result()  # a fault of the generator itself ends it here
    with lock:
        lat, late = latency.copy(), lateness.copy()
        got = dict(answers)
    pool.shutdown(wait=False, cancel_futures=True)

    decoded = {i: codec.served_answer(b) for i, b in got.items()}
    keys = sorted(decoded)
    np.savez(args.samples, index=np.array(keys, np.int64),
             payload=payload[keys].astype(np.int64) if keys else np.zeros(0, np.int64),
             answer=np.stack([decoded[k] for k in keys]) if keys else np.zeros((0, 1, 1), np.uint8))
    ok = np.isfinite(lat)
    third = max(1, n // 3)
    print(json.dumps({
        "sent": n, "ok": int(ok.sum()), "failed": int(n - ok.sum()),
        "latency_ms": [float(v * 1e3) if np.isfinite(v) else None for v in lat],
        "lateness_ms_p95": float(np.percentile(late, 95) * 1e3) if n else 0.0,
        "lateness_ms_max": float(late.max() * 1e3) if n else 0.0,
        "offered_per_s": n / args.seconds,
        "completed_per_s": float(ok.sum()) / (t_end - t0),
        "latency_slope_ms_per_s": float(np.polyfit(due[ok], lat[ok] * 1e3, 1)[0])
        if ok.sum() > 2 else 0.0,
        "first_third_p50_ms": float(np.median(lat[:third]) * 1e3) if n else 0.0,
        "last_third_p50_ms": float(np.median(lat[-third:]) * 1e3) if n else 0.0,
        "send_seconds": t_close - t0, "window_seconds": t_end - t0,
        "sampled": len(keys)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
