"""Annotation portal web server (counterpart of terra_gan_tpu/portal/server.py;
reference: Annotation_Portal_Code/app.py).

The reference Flask app's endpoints and semantics as a WSGI application
on the standard library alone, so that it runs where Flask is absent and
under any WSGI server (``python -m terra_gan_tpu_torch.portal.server``,
or the ``terra-gan-tpu-torch-portal`` script, serves it with wsgiref):

  * bearer auth on API routes with the reference's JWT semantics
    (app.py:38-55): the token must be a valid HS256 JWT signed with the
    server secret; missing/non-Bearer header -> 401 "No API key
    provided", invalid/expired token -> 401 "Invalid API key". A
    plain-string api_key mode is kept as a fallback for simple
    deployments.
  * GET  /                             — annotator UI (static/index.html)
  * GET  /static/<f>                   — UI assets
  * GET  /images                       — list annotatable images
  * POST /api/upload/<grid>            — multipart PNG batch upload,
    filenames prefixed with <grid>_ when missing (app.py:89-125)
  * POST /save_annotation              — base64 mask; rejected when its
    dimensions differ from the original image (app.py:127-171);
    saved as <image-stem>_<user_hash>_mask.png
  * GET  /api/annotations/<grid>       — list annotation files
  * GET  /api/annotations-file/<f>     — base64 body
  * GET  /api/file/<f>                 — raw stream
  * GET  /api/status/<grid>            — counts + completed flag
    (app.py:273-325)
  * POST /api/feedback/<grid>          — JSON feedback log
  * DELETE /api/delete/<grid>/<f>, POST /api/delete-batch/<grid>
"""

from __future__ import annotations

import base64
import email
import email.policy
import io
import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import jwt_auth

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent / "static"
MAX_CONTENT_LENGTH = 64 * 1024 * 1024

_CONTENT_TYPES = {
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript",
    ".css": "text/css",
    ".json": "application/json",
}


class _Response:
    def __init__(self, status: int, body: bytes, content_type: str):
        self.status = status
        self.body = body
        self.content_type = content_type


def _json(obj, status: int = 200) -> _Response:
    return _Response(status, json.dumps(obj).encode(), "application/json")


def _file(path: Path) -> _Response:
    ctype = _CONTENT_TYPES.get(path.suffix.lower(), "application/octet-stream")
    return _Response(200, path.read_bytes(), ctype)


_STATUS_TEXT = {
    200: "200 OK",
    400: "400 Bad Request",
    401: "401 Unauthorized",
    404: "404 Not Found",
    405: "405 Method Not Allowed",
    413: "413 Payload Too Large",
    500: "500 Internal Server Error",
}


def _read_body(environ) -> bytes:
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    if length > MAX_CONTENT_LENGTH:
        raise _TooLarge()
    return environ["wsgi.input"].read(length) if length else b""


class _TooLarge(Exception):
    pass


def _parse_multipart(environ) -> Dict[str, List[Tuple[str, bytes]]]:
    """Parse multipart/form-data into {field: [(filename, bytes), ...]}."""
    ctype = environ.get("CONTENT_TYPE", "")
    body = _read_body(environ)
    raw = b"Content-Type: " + ctype.encode("latin-1") + b"\r\nMIME-Version: 1.0\r\n\r\n" + body
    msg = email.message_from_bytes(raw, policy=email.policy.HTTP)
    fields: Dict[str, List[Tuple[str, bytes]]] = {}
    if not msg.is_multipart():
        return fields
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        filename = part.get_filename() or ""
        payload = part.get_payload(decode=True) or b""
        fields.setdefault(name, []).append((filename, payload))
    return fields


class PortalApp:
    """WSGI callable implementing the annotation portal."""

    def __init__(
        self,
        image_folder: str | Path = "static/images",
        annotation_folder: str | Path = "static/annotations",
        api_key: str = "",
        secret_key: str = "",
    ):
        self.image_folder = Path(image_folder)
        self.annotation_folder = Path(annotation_folder)
        self.image_folder.mkdir(parents=True, exist_ok=True)
        self.annotation_folder.mkdir(parents=True, exist_ok=True)
        self.api_key = api_key
        self.secret_key = secret_key
        # (method, path pattern, handler, protected) — compiled once
        routes = [
            ("GET", r"/", self._index, False),
            ("GET", r"/static/(?P<filename>[^/]+)", self._static, False),
            ("GET", r"/images", self._list_images, False),
            ("POST", r"/api/upload/(?P<grid>[^/]+)", self._upload, True),
            ("POST", r"/save_annotation", self._save_annotation, False),
            ("GET", r"/api/annotations/(?P<grid>[^/]+)", self._list_annotations, True),
            ("GET", r"/api/annotations-file/(?P<filename>.+)", self._annotation_file, True),
            ("GET", r"/api/file/(?P<filename>.+)", self._raw_file, True),
            ("GET", r"/api/status/(?P<grid>[^/]+)", self._status, True),
            ("POST", r"/api/feedback/(?P<grid>[^/]+)", self._feedback, True),
            ("DELETE", r"/api/delete/(?P<grid>[^/]+)/(?P<filename>.+)", self._delete, True),
            ("POST", r"/api/delete-batch/(?P<grid>[^/]+)", self._delete_batch, True),
        ]
        self._compiled = [
            (m, re.compile("^" + p + "$"), h, prot)
            for m, p, h, prot in routes
        ]

    # -- auth (reference semantics, app.py:38-55) ---------------------------
    def _authorize(self, environ) -> Optional[_Response]:
        """Return a 401 response, or None when the request is authorized."""
        if not self.api_key and not self.secret_key:
            return None  # open dev mode
        header = environ.get("HTTP_AUTHORIZATION", "")
        if not header.startswith("Bearer "):
            return _json({"error": "No API key provided"}, 401)
        token = header[len("Bearer "):]
        if self.secret_key:
            try:
                jwt_auth.decode(token, self.secret_key)
                return None
            except jwt_auth.InvalidTokenError:
                pass  # fall through to the plain-key fallback
        if self.api_key and token == self.api_key:
            return None
        return _json({"error": "Invalid API key"}, 401)

    # -- WSGI entry ----------------------------------------------------------
    def __call__(self, environ, start_response):
        method = environ.get("REQUEST_METHOD", "GET").upper()
        path = environ.get("PATH_INFO", "/")
        resp = None
        path_matched = False
        try:
            for m, pattern, handler, protected in self._compiled:
                match = pattern.match(path)
                if not match:
                    continue
                path_matched = True
                if m != method:
                    continue
                if protected:
                    denied = self._authorize(environ)
                    if denied is not None:
                        resp = denied
                        break
                resp = handler(environ, **match.groupdict())
                break
            if resp is None:
                resp = _json(
                    {"error": "method not allowed" if path_matched else "not found"},
                    405 if path_matched else 404,
                )
        except _TooLarge:
            resp = _json({"error": "payload too large"}, 413)
        except Exception as e:  # log-and-500, like the reference's handlers
            logger.exception("portal error on %s %s: %s", method, path, e)
            resp = _json({"error": "internal error"}, 500)
        start_response(
            _STATUS_TEXT.get(resp.status, f"{resp.status} Error"),
            [
                ("Content-Type", resp.content_type),
                ("Content-Length", str(len(resp.body))),
            ],
        )
        return [resp.body]

    # -- UI -------------------------------------------------------------------
    def _index(self, environ) -> _Response:
        index = STATIC_DIR / "index.html"
        if index.exists():
            return _file(index)
        return _json({"error": "not found"}, 404)

    def _static(self, environ, filename: str) -> _Response:
        path = STATIC_DIR / Path(filename).name
        if path.exists():
            return _file(path)
        return _json({"error": "not found"}, 404)

    # -- endpoints -------------------------------------------------------------
    def _list_images(self, environ) -> _Response:
        names = sorted(
            f for f in os.listdir(self.image_folder)
            if f.lower().endswith(".png")
        )
        return _json({"images": names})

    def _upload(self, environ, grid: str) -> _Response:
        fields = _parse_multipart(environ)
        if "files" not in fields:
            return _json({"error": "No files provided"}, 400)
        entries = fields["files"]
        if not entries:
            return _json({"error": "Empty files list"}, 400)
        saved = []
        for filename, payload in entries:
            if not filename:
                continue
            name = filename
            if not name.startswith(grid):
                name = f"{grid}_{name}"
            (self.image_folder / Path(name).name).write_bytes(payload)
            saved.append(name)
        return _json({"status": "success", "uploaded": saved})

    def _save_annotation(self, environ) -> _Response:
        from PIL import Image

        try:
            data = json.loads(_read_body(environ) or b"{}")
        except json.JSONDecodeError:
            return _json({"status": "error", "message": "bad json"}, 400)
        image_name = data.get("image_name", "")
        user_hash = data.get("user_hash", "anon")
        raw = data.get("mask", "")
        try:
            mask_bytes = base64.b64decode(raw.split(",", 1)[1])
        except (IndexError, ValueError):
            return _json({"status": "error", "message": "bad mask"}, 400)

        image_path = self.image_folder / Path(image_name).name
        if image_path.exists():
            with Image.open(image_path) as orig:
                ow, oh = orig.size
            with Image.open(io.BytesIO(mask_bytes)) as mask_img:
                mw, mh = mask_img.size
            if (mw, mh) != (ow, oh):
                return _json(
                    {
                        "status": "error",
                        "message": (
                            f"Mask dimensions ({mw}x{mh}) do not match "
                            f"original image ({ow}x{oh})"
                        ),
                    },
                    400,
                )
        stem = Path(image_name).stem
        out = self.annotation_folder / f"{stem}_{user_hash}_mask.png"
        out.write_bytes(mask_bytes)
        return _json({"status": "success"})

    def _list_annotations(self, environ, grid: str) -> _Response:
        names = sorted(
            f for f in os.listdir(self.annotation_folder)
            if f.endswith("_mask.png") and f.startswith(f"{grid}_")
        )
        return _json({"annotations": names})

    def _annotation_file(self, environ, filename: str) -> _Response:
        path = self.annotation_folder / Path(filename).name
        if not path.exists():
            return _json({"error": "not found"}, 404)
        return _json(
            {
                "filename": path.name,
                "content": base64.b64encode(path.read_bytes()).decode(),
            }
        )

    def _raw_file(self, environ, filename: str) -> _Response:
        for folder in (self.annotation_folder, self.image_folder):
            path = folder / Path(filename).name
            if path.exists():
                return _file(path)
        return _json({"error": "not found"}, 404)

    def _status(self, environ, grid: str) -> _Response:
        total = len([
            f for f in os.listdir(self.image_folder)
            if f.lower().endswith(".png") and f.startswith(f"{grid}_")
        ])
        grid_dir = self.image_folder / grid
        if grid_dir.exists():
            total += len([
                f for f in os.listdir(grid_dir) if f.lower().endswith(".png")
            ])
        annotated = len([
            f for f in os.listdir(self.annotation_folder)
            if f.endswith("_mask.png") and f.startswith(f"{grid}_")
        ])
        return _json({
            "grid_square": grid,
            "total_images": total,
            "annotated_images": annotated,
            "completed": total > 0 and annotated >= total,
        })

    def _feedback(self, environ, grid: str) -> _Response:
        try:
            payload = json.loads(_read_body(environ) or b"{}")
        except json.JSONDecodeError:
            return _json({"status": "error", "message": "bad json"}, 400)
        log = self.annotation_folder / f"{grid}_feedback.jsonl"
        with open(log, "a") as f:
            f.write(json.dumps({"ts": time.time(), **payload}) + "\n")
        return _json({"status": "success"})

    def _delete(self, environ, grid: str, filename: str) -> _Response:
        path = self.annotation_folder / Path(filename).name
        if not path.exists():
            return _json({"error": "not found"}, 404)
        path.unlink()
        return _json({"status": "success", "deleted": path.name})

    def _delete_batch(self, environ, grid: str) -> _Response:
        try:
            names = json.loads(_read_body(environ) or b"{}").get("filenames", [])
        except json.JSONDecodeError:
            return _json({"status": "error", "message": "bad json"}, 400)
        deleted = 0
        for name in names:
            path = self.annotation_folder / Path(name).name
            if path.exists():
                path.unlink()
                deleted += 1
        return _json({"status": "success", "deleted": deleted})


def create_app(
    image_folder: str | Path = "static/images",
    annotation_folder: str | Path = "static/annotations",
    api_key: str = "",
    secret_key: str = "",
) -> PortalApp:
    """Build the portal WSGI app."""
    return PortalApp(image_folder, annotation_folder, api_key, secret_key)


def main(argv=None) -> int:  # pragma: no cover - live server entry
    import argparse
    from wsgiref.simple_server import make_server

    p = argparse.ArgumentParser(description="Annotation portal server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--images", default="static/images")
    p.add_argument("--annotations", default="static/annotations")
    p.add_argument("--api-key", default=os.environ.get("PORTAL_API_KEY", ""))
    p.add_argument(
        "--secret-key",
        default=os.environ.get("PORTAL_SECRET_KEY", ""),
        help="HS256 JWT secret (reference auth mode, app.py:38-55)",
    )
    args = p.parse_args(argv)
    app = create_app(args.images, args.annotations, args.api_key, args.secret_key)
    server = make_server(args.host, args.port, app)
    logger.info("portal serving on %s:%d", args.host, args.port)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
