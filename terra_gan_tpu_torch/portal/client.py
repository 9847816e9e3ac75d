"""Annotation portal HTTP client (counterpart of terra_gan_tpu/portal/client.py).

The reference client's endpoints and semantics (utils/api/portal_client.py),
on the standard library's urllib:
  * bearer-token auth; every request retried as the JAX package's client
    retries it (portal_client.py:28-36): up to 5 retries on 429/500/502/
    503/504 and on connection errors, for GET, POST and DELETE, sleeping
    a Retry-After the server sends, else urllib3's backoff at factor 1.0
    (0 s before the first retry, then 2, 4, 8 and 16 s); any other error
    status fails at once
  * upload_batch: tiles POSTed 2 at a time (field ``files``) to
    /api/upload/<grid>, a pause between chunks (portal_client.py:65-129);
    the multipart body is built here
  * fetch_annotations: list /api/annotations/<grid>, then download each
    through /api/file/<name> (portal_client.py:131-166)
  * get_annotation_status -> /api/status/<grid>
  * submit_feedback -> POST /api/feedback/<grid>
  * create_test_file: a synthetic probe upload for a health check
  * delete_annotation / delete_processed_annotations, asking for
    confirmation unless EXPERIMENT_MODE is set (portal_client.py:250-351)
"""

from __future__ import annotations

import io
import json
import logging
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

UPLOAD_CHUNK = 2
CHUNK_DELAY_S = 1.0
RETRIES = 5
BACKOFF_FACTOR = 1.0
BACKOFF_MAX_S = 120.0
RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})


def experiment_mode() -> bool:
    return os.environ.get("EXPERIMENT_MODE", "").lower() in ("1", "true", "yes")


def backoff_s(retry: int) -> float:
    """The pause before retry number ``retry`` (1, 2, ...): 0 before the
    first, then BACKOFF_FACTOR * 2^(retry - 1), at most BACKOFF_MAX_S."""
    if retry <= 1:
        return 0.0
    return min(BACKOFF_MAX_S, BACKOFF_FACTOR * 2 ** (retry - 1))


def _retry_after(err: urllib.error.HTTPError) -> Optional[float]:
    value = err.headers.get("Retry-After") if err.headers else None
    try:
        return max(0.0, float(value)) if value is not None else None
    except ValueError:
        return None


def request(
    method: str,
    url: str,
    headers: Dict[str, str],
    body: Optional[bytes] = None,
    timeout: float = 60.0,
    retries: int = RETRIES,
) -> bytes:
    """The response body of ``method url``, retried on RETRY_STATUSES and
    connection errors; raises urllib's HTTPError for any other error
    status, or the last error once the retries are spent."""
    for attempt in range(retries + 1):
        req = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code not in RETRY_STATUSES or attempt == retries:
                raise
            pause = _retry_after(e)
            e.close()
        except urllib.error.URLError:
            if attempt == retries:
                raise
            pause = None
        logger.warning("%s %s failed; retry %d/%d", method, url, attempt + 1, retries)
        time.sleep(backoff_s(attempt + 1) if pause is None else pause)
    raise AssertionError("unreachable")


def multipart_body(field: str, files: Sequence[Tuple[str, bytes, str]]) -> Tuple[bytes, str]:
    """(body, content type) of a multipart/form-data upload of ``files``
    ((filename, data, content type) each) under one field name."""
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, data, ctype in files:
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="{field}"; '
                  f'filename="{name}"\r\n'.encode())
        out.write(f"Content-Type: {ctype}\r\n\r\n".encode())
        out.write(data)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


class PortalClient:
    def __init__(self, base_url: str, api_key: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.headers = {"Authorization": f"Bearer {api_key}"}

    def _call(self, method: str, path: str, body: Optional[bytes] = None,
              content_type: Optional[str] = None) -> bytes:
        headers = dict(self.headers)
        if content_type:
            headers["Content-Type"] = content_type
        url = f"{self.base_url}{urllib.parse.quote(path, safe='/')}"
        return request(method, url, headers, body, self.timeout)

    def _post_json(self, path: str, payload) -> Dict:
        raw = self._call("POST", path, json.dumps(payload).encode(), "application/json")
        return json.loads(raw or b"{}")

    def _upload(self, grid_square: str, files: Sequence[Tuple[str, bytes, str]]) -> None:
        body, ctype = multipart_body("files", files)
        self._call("POST", f"/api/upload/{grid_square}", body, ctype)

    # -- uploads ----------------------------------------------------------
    def upload_batch(self, grid_square: str, image_paths: Sequence[str | Path]) -> bool:
        valid = [Path(p) for p in image_paths if Path(p).exists()]
        if not valid:
            logger.warning("no valid files to upload for %s", grid_square)
            return False
        ok = 0
        n_chunks = -(-len(valid) // UPLOAD_CHUNK)
        for ci in range(n_chunks):
            chunk = valid[ci * UPLOAD_CHUNK : (ci + 1) * UPLOAD_CHUNK]
            try:
                self._upload(grid_square, [(p.name, p.read_bytes(), "image/png") for p in chunk])
                ok += len(chunk)
                logger.info("uploaded chunk %d/%d", ci + 1, n_chunks)
                if ci + 1 < n_chunks:
                    time.sleep(CHUNK_DELAY_S)
            except Exception as e:
                logger.error("chunk %d upload failed: %s", ci + 1, e)
        return ok == len(valid)

    def create_test_file(self, grid_square: str) -> bool:
        """Upload a tiny synthetic probe image to check the server's health."""
        try:
            import numpy as np
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(np.full((32, 32), 128, np.uint8)).save(buf, format="PNG")
            self._upload(grid_square, [("portal_test.png", buf.getvalue(), "image/png")])
            return True
        except Exception as e:
            logger.error("test upload failed: %s", e)
            return False

    # -- annotations ------------------------------------------------------
    def fetch_annotations(
        self, grid_square: str, download_dir: str | Path = "data/human_annotations"
    ) -> Optional[List[Path]]:
        """List and download a grid's annotation PNGs into <download_dir>/<grid>."""
        try:
            names = json.loads(self._call("GET", f"/api/annotations/{grid_square}")).get(
                "annotations", [])
        except Exception as e:
            logger.error("annotation listing failed: %s", e)
            return None
        out_dir = Path(download_dir) / grid_square
        out_dir.mkdir(parents=True, exist_ok=True)
        downloaded = []
        for name in names:
            try:
                dest = out_dir / Path(name).name
                dest.write_bytes(self._call("GET", f"/api/file/{name}"))
                downloaded.append(dest)
            except Exception as e:
                logger.error("download failed for %s: %s", name, e)
        return downloaded

    def get_annotation_status(self, grid_square: str) -> Optional[Dict]:
        try:
            return json.loads(self._call("GET", f"/api/status/{grid_square}"))
        except Exception as e:
            logger.error("status fetch failed: %s", e)
            return None

    def submit_feedback(self, grid_square: str, feedback: Dict) -> bool:
        try:
            self._post_json(f"/api/feedback/{grid_square}", feedback)
            return True
        except Exception as e:
            logger.error("feedback submit failed: %s", e)
            return False

    # -- deletion ---------------------------------------------------------
    def delete_annotation(self, grid_square: str, filename: str, confirm: bool = True) -> bool:
        if confirm and not experiment_mode():
            answer = input(f"Delete {filename} from portal? [y/N] ")
            if answer.strip().lower() not in ("y", "yes"):
                return False
        try:
            self._call("DELETE", f"/api/delete/{grid_square}/{filename}")
            return True
        except Exception as e:
            logger.error("delete failed for %s: %s", filename, e)
            return False

    def delete_processed_annotations(
        self, grid_square: str, filenames: Sequence[str], confirm: bool = True
    ) -> int:
        """Batch deletion after a successful fine-tune; the count deleted."""
        if confirm and not experiment_mode():
            answer = input(f"Delete {len(filenames)} processed annotations for "
                           f"{grid_square}? [y/N] ")
            if answer.strip().lower() not in ("y", "yes"):
                return 0
        try:
            resp = self._post_json(f"/api/delete-batch/{grid_square}",
                                   {"filenames": list(filenames)})
            return resp.get("deleted", len(filenames))
        except Exception as e:
            logger.error("batch delete failed: %s", e)
            return 0
