"""Python client for the inpainting service (serving/server.py).

The port's copy of terra_gan_tpu/serving/client.py: applications talk to
a remote inpainting service through numpy arrays (or files) without
knowing the wire format.

  * standard library HTTP (urllib) and the port's HS256 JWT helper
  * retries with jittered exponential backoff on connection errors and
    on 5xx/429, never on other client errors
  * auth: a pre-signed bearer token, or a shared secret from which the
    client signs short-lived tokens itself (portal/jwt_auth.py)
  * PNG wire codec through PIL

Also a CLI, the remote analogue of `inpaint_directory` for hosts
without a card:

  python -m terra_gan_tpu_torch.serving.client --url http://gpu-host:8500 \\
      --images dir/ --masks dir/ --out out/ [--secret ...]
"""

from __future__ import annotations

import base64
import io
import json
import logging
import random
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..portal import jwt_auth

logger = logging.getLogger(__name__)

# statuses worth retrying: transient server states, never client errors
_RETRY_STATUSES = {429, 500, 502, 503, 504}


class ServingError(RuntimeError):
    """Request failed after retries (terminal server or connection error)."""


def _png_b64(u8: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(u8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _open_gray(path: str | Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"), np.uint8)


class InpaintClient:
    """Typed client over the serving HTTP API."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        auth_secret: Optional[str] = None,
        token_ttl_s: float = 300.0,
        timeout: float = 120.0,
        max_retries: int = 4,
        backoff_s: float = 0.5,
    ):
        self.base_url = base_url.rstrip("/")
        self._token = token
        self._secret = auth_secret
        self._token_ttl = token_ttl_s
        self._token_exp = 0.0
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_s = backoff_s

    # -- auth ---------------------------------------------------------------
    def _bearer(self) -> Optional[str]:
        if self._token is not None:
            return self._token
        if self._secret is None:
            return None
        now = time.time()
        if now >= self._token_exp - 30.0:  # refresh with a 30 s margin
            self._signed = jwt_auth.encode(
                {"sub": "inpaint-client"}, self._secret, expires_in=self._token_ttl
            )
            self._token_exp = now + self._token_ttl
        return self._signed

    # -- transport ----------------------------------------------------------
    def _request(self, path: str, payload: Optional[Dict] = None) -> Dict:
        url = f"{self.base_url}{path}"
        data = json.dumps(payload).encode() if payload is not None else None
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            headers = {"Content-Type": "application/json"}
            bearer = self._bearer()
            if bearer:
                headers["Authorization"] = f"Bearer {bearer}"
            req = urllib.request.Request(url, data=data, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code not in _RETRY_STATUSES:
                    # 4xx: surface the server's error message as it is
                    try:
                        detail = json.loads(e.read()).get("error", "")
                    except Exception:
                        detail = ""
                    raise ServingError(f"{path} -> HTTP {e.code}: {detail or e.reason}") from e
                last = e
            except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
                last = e
            if attempt < self.max_retries:
                delay = self.backoff_s * (2**attempt) * (0.5 + random.random())
                logger.warning("retry %d/%d for %s in %.1fs (%s)",
                               attempt + 1, self.max_retries, path, delay, last)
                time.sleep(delay)
        raise ServingError(
            f"{path} failed after {self.max_retries + 1} attempts: {last}"
        ) from last

    # -- codecs -------------------------------------------------------------
    @staticmethod
    def _encode_png(array: np.ndarray) -> str:
        u8 = np.asarray(array)
        if u8.ndim == 3:
            u8 = u8[..., 0]
        if u8.dtype != np.uint8:
            u8 = (np.clip(u8, 0.0, 1.0) * 255).astype(np.uint8)
        return _png_b64(u8)

    @staticmethod
    def _decode_png(b64: str) -> np.ndarray:
        from PIL import Image

        raw = base64.b64decode(b64)
        return np.asarray(Image.open(io.BytesIO(raw)).convert("L"), np.uint8)

    @staticmethod
    def _as_mask_u8(mask: np.ndarray) -> np.ndarray:
        m = np.asarray(mask)
        if m.ndim == 3:
            m = m[..., 0]
        return (m > 0).astype(np.uint8) * 255

    # -- API ----------------------------------------------------------------
    def healthz(self) -> Dict:
        return self._request("/healthz")

    def stats(self) -> Dict:
        return self._request("/stats")

    def inpaint(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One (H,W[,1]) grayscale tile and a 0/255 (or 0/1) mask ->
        the inpainted uint8 (H,W) at the server's output contract."""
        out = self._request("/inpaint", {
            "image": self._encode_png(image),
            "mask": self._encode_png(self._as_mask_u8(mask)),
        })
        return self._decode_png(out["inpainted"])

    def inpaint_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> List[np.ndarray]:
        out = self._request("/inpaint_batch", {"items": [
            {"image": self._encode_png(img), "mask": self._encode_png(self._as_mask_u8(m))}
            for img, m in pairs
        ]})
        return [self._decode_png(b) for b in out["inpainted"]]

    def inpaint_files(
        self, image_path: str | Path, mask_path: str | Path, out_path: str | Path
    ) -> Path:
        from PIL import Image

        out = self.inpaint(_open_gray(image_path), _open_gray(mask_path))
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(out).save(out_path)
        return out_path


def main(argv=None) -> int:
    """Remote batch inpainting: the reference's evaluate loop
    (main_pipeline.py:497-539) pointed at a serving endpoint."""
    import argparse
    import os

    from PIL import Image

    from ..evaluation.inference import iter_tile_pairs

    p = argparse.ArgumentParser(description="Remote inpainting through a serving endpoint")
    p.add_argument("--url", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--masks", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8, help="tiles per /inpaint_batch request")
    p.add_argument("--secret", default=None,
                   help="HS256 secret (or TERRA_GAN_TPU_SERVING_SECRET) to sign bearer tokens")
    p.add_argument("--token", default=None, help="pre-signed bearer token")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    client = InpaintClient(
        args.url, token=args.token,
        auth_secret=args.secret or os.environ.get("TERRA_GAN_TPU_SERVING_SECRET"),
    )
    logger.info("server ok: %s", client.healthz())
    pairs = [(img, m) for img, m in iter_tile_pairs(args.images, args.masks) if m is not None]
    if not pairs:
        logger.error("no tile/mask pairs under %s", args.images)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for s in range(0, len(pairs), args.batch):
        chunk = pairs[s : s + args.batch]
        outs = client.inpaint_batch([(_open_gray(i), _open_gray(m)) for i, m in chunk])
        for (img_path, _), out in zip(chunk, outs):
            Image.fromarray(out).save(out_dir / f"{Path(img_path).stem}_inpainted.png")
    dt = time.perf_counter() - t0
    logger.info("%d tiles in %.1fs (%.1f tiles/s)", len(pairs), dt, len(pairs) / dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
