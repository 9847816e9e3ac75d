"""The open-loop generator against a slow stand-in server: requests go out
at their due times whatever the server does, a request's latency runs
from its due time, and the generator reports how late it sent."""

import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np

from torch_bench import codec

ROOT = Path(__file__).resolve().parents[2]
SERVICE_S = 0.05


class OneAtATime(BaseHTTPRequestHandler):
    """Answers /inpaint with the request's image after SERVICE_S, one request
    at a time (HTTPServer is single-threaded), so a queue builds."""

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        time.sleep(SERVICE_S)
        out = json.dumps({"inpainted": body["image"]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


class Backlog(HTTPServer):
    request_queue_size = 256  # the queue is the test's, not the socket's


def run_loadgen(tmp_path, rate, seconds):
    server = Backlog(("127.0.0.1", 0), OneAtATime)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    tiles = [np.full((16, 16, 1), 10 * i, np.uint8) for i in range(4)]
    (tmp_path / "b.jsonl").write_bytes(b"\n".join(codec.inpaint_body(t, t) for t in tiles))
    cmd = [sys.executable, str(ROOT / "torch_bench/loadgen.py"),
           "--url", f"http://127.0.0.1:{server.server_address[1]}", "--bodies",
           str(tmp_path / "b.jsonl"), "--rate", str(rate), "--seconds", str(seconds),
           "--seed", "3", "--samples", str(tmp_path / "s.npz"), "--sample-share", "1"]
    try:
        out = subprocess.run(cmd, input="go\n", capture_output=True, text=True, timeout=120)
    finally:
        server.shutdown()
        server.server_close()
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "ready", out.stderr[-2000:]
    return json.loads(lines[-1]), dict(np.load(tmp_path / "s.npz"))


def test_below_capacity_latency_is_the_service_time(tmp_path):
    res, samples = run_loadgen(tmp_path, rate=5, seconds=2)
    lat = np.array(res["latency_ms"])
    assert res["failed"] == 0 and res["ok"] == res["sent"] > 3
    assert (lat >= SERVICE_S * 1e3).all() and np.median(lat) < 4 * SERVICE_S * 1e3
    assert res["lateness_ms_p95"] < 20
    # the sampled answers decode to the tiles sent
    for p, a in zip(samples["payload"], samples["answer"]):
        assert (a == 10 * p).all()


def test_above_capacity_the_queue_grows_and_counts(tmp_path):
    res, _ = run_loadgen(tmp_path, rate=60, seconds=2)  # 3x what one-at-a-time serves
    lat = np.array(res["latency_ms"])
    assert res["sent"] > 80 and res["failed"] == 0
    # sends kept to the schedule, so the wait in the queue shows in the latency
    assert res["lateness_ms_p95"] < 50
    assert res["last_third_p50_ms"] > 3 * res["first_third_p50_ms"]
    assert res["latency_slope_ms_per_s"] > 100 and lat.max() > 1000
