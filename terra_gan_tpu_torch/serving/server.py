"""Inference serving on the card: an HTTP service with dynamic micro-batching.

The port of terra_gan_tpu/serving/server.py, over either of the port's
generators (a checkpoint's keys say which):

  * POST /inpaint        — body {"image": <b64 PNG>, "mask": <b64 PNG>}
                           -> {"inpainted": <b64 PNG>} at the
                           reference's 500x500 output contract
  * POST /inpaint_batch  — {"items": [{image, mask}, ...]} -> list
  * GET  /healthz        — liveness and the CUDA devices (always open)
  * GET  /stats          — request/batch/error counters, latency p50/p95
                           over the recent window and an EWMA,
                           queue-depth and in-flight gauges (JSON)
  * GET  /metrics        — the same snapshot in Prometheus text
                           exposition format

Auth: with a secret (--auth-secret or TERRA_GAN_TPU_SERVING_SECRET),
every endpoint but /healthz needs `Authorization: Bearer <HS256 JWT>`
signed with it (portal/jwt_auth.py); 401 on a missing or invalid token.
Bodies above --max-body-mb are refused with 413 before they are read.

Requests are queued and coalesced into device batches of up to
`max_batch`, padded to one of the warmed buckets {1, max_batch // 4,
max_batch}. A batch goes up as one stacked uint8 tensor (image and 0/1
mask), is normalised and run on the card, quantised to uint8 there, and
comes back at 1 byte a pixel; PIL decodes and encodes the PNGs. The
model is fp32 (the port has no bf16 mode yet); on a card its eval
forward runs the tail through K3 (ops/cuda/tail_kernel.py).

Run: python -m terra_gan_tpu_torch.serving.server --checkpoint master.pth
        [--port 8500] [--size 512] [--max-batch 16]
"""

from __future__ import annotations

import base64
import io
import json
import logging
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..portal import jwt_auth
from ..utils.device import resolve_device
from ..utils.weights import init_generator, load_generator

logger = logging.getLogger(__name__)


SEED = 0  # random weights when there is no checkpoint, as the JAX server's PRNGKey(0)


class BadRequestError(ValueError):
    """Client-side input problem (undecodable image, wrong type) -> 400."""


class MicroBatcher:
    """Coalesces single requests into device batches."""

    # sliding window for the latency percentiles: big enough for a stable
    # p95 under load, small enough that numpy.percentile over it costs
    # microseconds per /stats hit
    LATENCY_WINDOW = 512

    def __init__(self, infer_fn, max_batch: int = 16, max_wait_ms: float = 5.0):
        self.infer_fn = infer_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.queue: "queue.Queue" = queue.Queue()
        self.stats = {
            "requests": 0, "batches": 0, "batch_size_sum": 0,
            "errors": 0, "latency_ewma_ms": 0.0,
        }
        self._latencies = deque(maxlen=self.LATENCY_WINDOW)
        self._inflight = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time stats with p50/p95 over the recent window and the
        live queue and in-flight gauges (served by /stats and /metrics)."""
        with self._lock:
            s = dict(self.stats)
            lat = list(self._latencies)
            inflight = self._inflight
        s["mean_batch"] = s["batch_size_sum"] / s["batches"] if s["batches"] else 0
        if lat:
            s["latency_p50_ms"] = round(float(np.percentile(lat, 50)), 2)
            s["latency_p95_ms"] = round(float(np.percentile(lat, 95)), 2)
        else:
            s["latency_p50_ms"] = s["latency_p95_ms"] = 0.0
        s["queue_depth"] = self.queue.qsize()
        s["inflight"] = inflight
        return s

    def submit(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Blocking single-item inference through the batcher."""
        event = threading.Event()
        slot: Dict[str, Any] = {}
        t0 = time.perf_counter()
        with self._lock:
            self._inflight += 1
        self.queue.put((image, mask, event, slot))
        event.wait()
        with self._lock:
            self._inflight -= 1
            self.stats["requests"] += 1
            if "error" in slot:
                self.stats["errors"] += 1
            dt = (time.perf_counter() - t0) * 1000.0
            self._latencies.append(dt)
            ewma = self.stats["latency_ewma_ms"]
            self.stats["latency_ewma_ms"] = 0.9 * ewma + 0.1 * dt if ewma else dt
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["output"]

    def _loop(self) -> None:
        while True:
            batch = [self.queue.get()]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            images = np.stack([b[0] for b in batch])
            masks = np.stack([b[1] for b in batch])
            try:
                outputs = self.infer_fn(images, masks)
                for i, (_, _, event, slot) in enumerate(batch):
                    slot["output"] = outputs[i]
                    event.set()
            except Exception as e:  # propagated to every request of the batch
                logger.exception("batch inference failed")
                for _, _, event, slot in batch:
                    slot["error"] = str(e)
                    event.set()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["batch_size_sum"] += len(batch)


class InpaintService:
    """Model, batcher and codecs behind the HTTP handler.

    The generator comes from a reference-layout ``.pth`` (``checkpoint``;
    a PConvUNet, an FFCResNetGenerator or a DeepFillV2Generator, by its
    keys) or, without one,
    from a PConvUNet's random weights seeded with ``SEED``
    (``init_generator``). It runs on ``device``, the card unless the
    caller asks for the CPU, in eval mode, fp32.
    """

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        size: int = 512,
        out_size: int = 500,
        max_batch: int = 16,
        base_width: int = 64,
        device="cuda",
    ):
        self.size = size
        self.out_size = out_size
        self.device = resolve_device(device)
        if checkpoint and Path(checkpoint).exists():
            self.generator = load_generator(checkpoint, self.device)
            logger.info("serving checkpoint %s", checkpoint)
        else:
            logger.warning("no checkpoint; serving random weights (seed %d)", SEED)
            self.generator = init_generator(base_width, torch.Generator().manual_seed(SEED),
                                            self.device)
        # torch turns division by a Python scalar on CUDA into a multiply
        # by its reciprocal; a device tensor keeps /255 exact
        self._255 = torch.full((), 255.0, device=self.device)
        self._buckets = sorted({1, max(1, max_batch // 4), max_batch})
        self.batcher = MicroBatcher(self._infer, max_batch=max_batch)

    @torch.inference_mode()
    def _forward(self, xm_u8: torch.Tensor) -> torch.Tensor:
        # one stacked uint8 upload per batch (image in channel 0, the 0/1
        # mask in channel 1); u8 / 255 on the device is bit-identical to
        # the host's float32 / 255
        x = xm_u8[..., 0:1].float() / self._255
        m = xm_u8[..., 1:2].float()
        out = self.generator(x * m, m)
        # PNG quantisation on the device: 1 byte a pixel comes back
        return (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    def _upload(self, xm: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(xm))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def warmup(self) -> None:
        """One forward at every batch bucket, before traffic arrives."""
        for b in self._buckets:
            xm = np.zeros((b, self.size, self.size, 2), np.uint8)
            xm[..., 1] = 1
            self._forward(self._upload(xm)).cpu()
        logger.info("warmed batch buckets %s", self._buckets)

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _infer(self, images: np.ndarray, masks: np.ndarray) -> np.ndarray:
        n = images.shape[0]
        b = self._bucket(n)
        xm = np.concatenate([images, masks], axis=-1)  # (n, H, W, 2) uint8
        if n < b:  # pad to a warmed bucket
            xm = np.concatenate([xm, np.repeat(xm[-1:], b - n, axis=0)])
        return self._forward(self._upload(xm))[:n].cpu().numpy()

    # -- codecs -------------------------------------------------------------
    def decode_pair(self, item: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """(image, 0/1 mask), uint8 [size, size, 1] each, from a request item."""
        from PIL import Image

        if not isinstance(item, dict):
            raise BadRequestError("each item must be a JSON object")

        def decode(field: str) -> np.ndarray:
            b64 = item[field]  # KeyError -> 400 "missing field"
            if not isinstance(b64, str):
                raise BadRequestError(f"{field} must be a base64 string")
            try:
                raw = base64.b64decode(b64, validate=True)
            except Exception as e:
                raise BadRequestError(f"undecodable {field}: {e}") from e
            try:
                img = Image.open(io.BytesIO(raw)).convert("L")
            except Exception as e:
                raise BadRequestError(f"undecodable {field}: {e}") from e
            if img.size != (self.size, self.size):
                img = img.resize((self.size, self.size), Image.BILINEAR)
            return np.asarray(img, np.uint8)[..., None]

        image = decode("image")
        mask = (decode("mask") > 0).astype(np.uint8)
        return image, mask

    def encode_output(self, array01: np.ndarray) -> str:
        """Base64 PNG of one output at out_size; uint8 (device-quantised) or float in [0, 1]."""
        from PIL import Image

        if array01.dtype == np.uint8:
            u8 = array01[..., 0]
        else:
            u8 = (np.clip(array01[..., 0], 0, 1) * 255).astype(np.uint8)
        img = Image.fromarray(np.ascontiguousarray(u8))
        if self.out_size and u8.shape != (self.out_size, self.out_size):
            img = img.resize((self.out_size, self.out_size), Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()


def _devices(service: InpaintService):
    if service.device.type == "cuda":
        return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return [str(service.device)]


def make_server(
    service: InpaintService,
    host: str,
    port: int,
    auth_secret: Optional[str] = None,
    max_body_bytes: int = 32 * 1024 * 1024,
    max_batch_items: int = 64,
):
    class Handler(BaseHTTPRequestHandler):
        # headers and the ~340 KB base64 body go out as separate writes;
        # with Nagle on, the second waits for the peer's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            """Bearer-JWT check (HS256, 401 on any missing, malformed or
            expired token). /healthz stays open for liveness probes."""
            if auth_secret is None:
                return True
            header = self.headers.get("Authorization", "")
            if not header.startswith("Bearer "):
                self._json({"error": "missing bearer token"}, 401)
                return False
            try:
                jwt_auth.decode(header[len("Bearer "):].strip(), auth_secret)
            except jwt_auth.InvalidTokenError as e:
                self._json({"error": f"invalid token: {e}"}, 401)
                return False
            return True

        def do_GET(self):
            if self.path == "/healthz":
                return self._json({
                    "status": "ok",
                    "devices": _devices(service),
                    "device": str(service.device),
                    "model_size": service.size,
                    "auth": auth_secret is not None,
                })
            if not self._authorized():
                return
            if self.path == "/stats":
                return self._json(service.batcher.snapshot())
            if self.path == "/metrics":
                s = service.batcher.snapshot()
                lines = []
                for name, kind, value in (
                    ("requests_total", "counter", s["requests"]),
                    ("errors_total", "counter", s["errors"]),
                    ("batches_total", "counter", s["batches"]),
                    ("batch_size_mean", "gauge", s["mean_batch"]),
                    ("latency_p50_ms", "gauge", s["latency_p50_ms"]),
                    ("latency_p95_ms", "gauge", s["latency_p95_ms"]),
                    ("latency_ewma_ms", "gauge", s["latency_ewma_ms"]),
                    ("queue_depth", "gauge", s["queue_depth"]),
                    ("inflight_requests", "gauge", s["inflight"]),
                ):
                    metric = f"terra_gan_tpu_{name}"  # the JAX server's names
                    lines.append(f"# TYPE {metric} {kind}")
                    lines.append(f"{metric} {value}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            if not self._authorized():
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return self._json({"error": "bad content-length"}, 400)
            if length > max_body_bytes:
                return self._json({"error": f"body exceeds {max_body_bytes} bytes"}, 413)
            if length <= 0:
                return self._json({"error": "empty body"}, 400)
            try:
                payload = json.loads(self.rfile.read(length))
            except (json.JSONDecodeError, UnicodeDecodeError):
                return self._json({"error": "bad json"}, 400)
            if not isinstance(payload, dict):
                return self._json({"error": "body must be a JSON object"}, 400)
            try:
                if self.path == "/inpaint":
                    image, mask = service.decode_pair(payload)
                    out = service.batcher.submit(image, mask)
                    return self._json({"inpainted": service.encode_output(out)})
                if self.path == "/inpaint_batch":
                    items = payload.get("items", [])
                    if not isinstance(items, list):
                        return self._json({"error": "items must be a list"}, 400)
                    if len(items) > max_batch_items:
                        return self._json({"error": f"at most {max_batch_items} items"}, 400)
                    results = []
                    for item in items:
                        image, mask = service.decode_pair(item)
                        out = service.batcher.submit(image, mask)
                        results.append(service.encode_output(out))
                    return self._json({"inpainted": results})
            except KeyError as e:
                return self._json({"error": f"missing field {e}"}, 400)
            except BadRequestError as e:
                return self._json({"error": str(e)}, 400)
            except Exception as e:
                logger.exception("request failed")
                return self._json({"error": str(e)}, 500)
            self._json({"error": "not found"}, 404)

    return ThreadingHTTPServer((host, port), Handler)


NOT_PORTED = ("bf16", "quant", "calib_dir", "exported")


def main(argv=None) -> int:
    import argparse
    import os
    import signal

    p = argparse.ArgumentParser(description="Inpainting inference service (PyTorch, CUDA)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out-size", type=int, default=500)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--base-width", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--fp32", action="store_true",
                   help="exact fp32 mode: the port's only mode, and its default")
    p.add_argument("--bf16", action="store_true", help="not ported yet")
    p.add_argument("--quant", choices=["w8a8", "w8a8_resident"], default=None,
                   help="not ported yet")
    p.add_argument("--calib-dir", default=None, help="not ported yet")
    p.add_argument("--exported", default=None, help="not ported yet")
    p.add_argument("--auth-secret", default=None,
                   help="HS256 JWT secret; defaults to the TERRA_GAN_TPU_SERVING_SECRET "
                        "env var. Unset = open server (logged loudly).")
    p.add_argument("--max-body-mb", type=int, default=32)
    args = p.parse_args(argv)
    for name in NOT_PORTED:
        if getattr(args, name):
            p.error(f"--{name.replace('_', '-')} is not ported yet: the PyTorch port "
                    "serves fp32 checkpoints only")

    logging.basicConfig(level=logging.INFO)
    secret = args.auth_secret or os.environ.get("TERRA_GAN_TPU_SERVING_SECRET")
    if not secret:
        logger.warning("serving WITHOUT auth: set --auth-secret or "
                       "TERRA_GAN_TPU_SERVING_SECRET for production")
    service = InpaintService(
        checkpoint=args.checkpoint, size=args.size, out_size=args.out_size,
        max_batch=args.max_batch, base_width=args.base_width, device=args.device,
    )
    service.warmup()
    server = make_server(service, args.host, args.port, auth_secret=secret,
                         max_body_bytes=args.max_body_mb * 1024 * 1024)
    logger.info("serving on %s:%d", args.host, args.port)

    # graceful drain: SIGTERM/SIGINT stop accepting new connections and let
    # in-flight requests finish (ThreadingHTTPServer joins its non-daemon
    # handler threads on server_close); a second signal exits at once
    def _drain(signum, frame):
        logger.info("signal %d: draining; no new connections, in-flight requests finish",
                    signum)
        signal.signal(signum, signal.SIG_DFL)
        # shutdown() blocks until serve_forever returns: not on its thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    server.daemon_threads = False
    server.serve_forever()
    server.server_close()
    logger.info("drained; exiting")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
