"""PythonAnywhere files-API tools (counterpart of
terra_gan_tpu/portal/pythonanywhere.py; reference: utils/api/
pythonanywhere_downloader.py, pythonanywhere_cleanup.py,
download_all_annotations.py, annotations_uploader.py), on urllib.

Direct access to the portal host's file tree when the portal runs on
PythonAnywhere: list/download annotations per grid, bulk download with
jittered exponential backoff over a thread pool, server-side deletion
of processed files, and multipart re-upload. Every operation is also
importable for programmatic use.
"""

from __future__ import annotations

import json
import logging
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import List, Optional, Tuple

from .client import multipart_body

logger = logging.getLogger(__name__)

API_BASE = "https://www.pythonanywhere.com/api/v0/user/{user}"


class PythonAnywhereClient:
    def __init__(self, username: str, token: str, timeout: float = 60.0):
        self.username = username
        self.base = API_BASE.format(user=username)
        self.headers = {"Authorization": f"Token {token}"}
        self.timeout = timeout

    def _open(self, method: str, path: str, body: Optional[bytes] = None,
              content_type: Optional[str] = None) -> Tuple[int, bytes]:
        """(status, body) of one request; an error status is returned, not raised."""
        headers = dict(self.headers)
        if content_type:
            headers["Content-Type"] = content_type
        req = urllib.request.Request(f"{self.base}{path}", data=body, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, b""

    def _ok(self, method: str, path: str) -> bytes:
        status, body = self._open(method, path)
        if status >= 400:
            raise RuntimeError(f"{method} {path}: HTTP {status}")
        return body

    # -- tree / file primitives --------------------------------------------
    def list_tree(self, remote_path: str) -> List[str]:
        query = urllib.parse.quote(remote_path, safe="/")
        return [p for p in json.loads(self._ok("GET", f"/files/tree/?path={query}"))
                if not p.endswith("/")]

    def download_file(self, remote_path: str, dest: Path) -> Path:
        data = self._ok("GET", f"/files/path{urllib.parse.quote(remote_path, safe='/')}")
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(data)
        return dest

    def delete_file(self, remote_path: str) -> bool:
        status, _ = self._open("DELETE",
                               f"/files/path{urllib.parse.quote(remote_path, safe='/')}")
        return status in (200, 204)

    def upload_file(self, local_path: Path, remote_path: str) -> bool:
        body, ctype = multipart_body(
            "content", [(Path(local_path).name, Path(local_path).read_bytes(),
                         "application/octet-stream")])
        status, _ = self._open("POST", f"/files/path{urllib.parse.quote(remote_path, safe='/')}",
                               body, ctype)
        return status in (200, 201)

    # -- grid-level operations ----------------------------------------------
    def download_annotations_for_grid(
        self,
        grid_square: str,
        remote_dir: str,
        local_dir: str | Path,
    ) -> List[Path]:
        files = [
            p for p in self.list_tree(remote_dir)
            if Path(p).name.startswith(f"{grid_square}_")
            and p.endswith("_mask.png")
        ]
        out = []
        for remote in files:
            dest = Path(local_dir) / Path(remote).name
            try:
                out.append(self.download_file(remote, dest))
            except Exception as e:
                logger.error("download failed %s: %s", remote, e)
        return out

    def download_all(
        self,
        remote_dir: str,
        local_dir: str | Path,
        max_workers: int = 4,
        max_retries: int = 5,
    ) -> List[Path]:
        """Bulk download with jittered exponential backoff per file."""
        files = self.list_tree(remote_dir)
        local_dir = Path(local_dir)

        def one(remote: str) -> Optional[Path]:
            for attempt in range(max_retries):
                try:
                    return self.download_file(
                        remote, local_dir / Path(remote).name
                    )
                except Exception as e:
                    delay = min(60.0, (2 ** attempt) + random.random())
                    logger.warning(
                        "retry %d for %s in %.1fs (%s)",
                        attempt + 1, remote, delay, e,
                    )
                    time.sleep(delay)
            logger.error("gave up on %s", remote)
            return None

        out: List[Path] = []
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = {pool.submit(one, f): f for f in files}
            for fut in as_completed(futures):
                result = fut.result()
                if result is not None:
                    out.append(result)
        logger.info("downloaded %d/%d files", len(out), len(files))
        return out

    def cleanup_remote(
        self,
        remote_dir: str,
        grid_square: Optional[str] = None,
        suffix: str = ".png",
    ) -> int:
        """Delete remote files (optionally grid-filtered); returns count."""
        files = self.list_tree(remote_dir)
        if grid_square:
            files = [
                p for p in files
                if Path(p).name.startswith(f"{grid_square}_")
            ]
        files = [p for p in files if p.endswith(suffix)]
        deleted = 0
        for p in files:
            if self.delete_file(p):
                deleted += 1
        logger.info("deleted %d/%d remote files", deleted, len(files))
        return deleted

    def upload_annotations(
        self, local_dir: str | Path, remote_dir: str
    ) -> int:
        """Multipart re-upload of local annotation PNGs."""
        count = 0
        for p in sorted(Path(local_dir).glob("*.png")):
            if self.upload_file(p, f"{remote_dir.rstrip('/')}/{p.name}"):
                count += 1
            else:
                logger.error("upload failed for %s", p.name)
        return count


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="PythonAnywhere file tools")
    p.add_argument("command", choices=["download", "download-all", "cleanup", "upload"])
    p.add_argument("--username", required=True)
    p.add_argument("--token", required=True)
    p.add_argument("--remote-dir", required=True)
    p.add_argument("--local-dir", default="data/human_annotations")
    p.add_argument("--grid")
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)

    client = PythonAnywhereClient(args.username, args.token)
    if args.command == "download":
        if not args.grid:
            p.error("--grid required for download")
        files = client.download_annotations_for_grid(
            args.grid, args.remote_dir, args.local_dir
        )
        print(f"downloaded {len(files)} files")
    elif args.command == "download-all":
        files = client.download_all(
            args.remote_dir, args.local_dir, max_workers=args.workers
        )
        print(f"downloaded {len(files)} files")
    elif args.command == "cleanup":
        print(f"deleted {client.cleanup_remote(args.remote_dir, args.grid)}")
    else:
        print(f"uploaded {client.upload_annotations(args.local_dir, args.remote_dir)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
