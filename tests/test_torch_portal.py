"""The port's portal layer against the JAX package's, over live HTTP on 127.0.0.1.

The port's ``PortalClient`` (urllib) is driven against
``tests/fake_portal.py`` and against both packages' WSGI portal servers
in a thread: auth (JWT bearer, 401s), the multipart upload and its grid
prefix, ``/save_annotation`` (names, a size mismatch), listing, status,
files, feedback, deletion, the 64 MB limit. Its retry is held to the JAX
client's (urllib3's Retry): a 503 retried with its backoff (sleep patched out),
a 404 and a 401 never. The matching helpers, ``validate_dataset``,
``upload_results`` and the PythonAnywhere client are held to the JAX
package's on the same trees.
"""

from __future__ import annotations

import base64
import importlib
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from wsgiref.simple_server import WSGIRequestHandler, make_server

import numpy as np
import pytest
from PIL import Image

from fake_portal import make_handler, new_store
from test_pythonanywhere import TOKEN, FakePA
from terra_gan_tpu.config import Config as JConfig
from terra_gan_tpu.data.dataset import DirectMatchDataset as JDirectMatchDataset
from terra_gan_tpu.portal import helpers as jhelpers
from terra_gan_tpu.portal import server as jserver
from terra_gan_tpu_torch import portal
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.data.dataset import DirectMatchDataset
from terra_gan_tpu_torch.portal import client as client_mod
from terra_gan_tpu_torch.portal import helpers, jwt_auth, pythonanywhere
from terra_gan_tpu_torch.portal import server as server_mod
from terra_gan_tpu_torch.portal.client import PortalClient

# the package's upload_results is the function: the module by its full name
upload_mod = importlib.import_module("terra_gan_tpu_torch.portal.upload_results")

API_KEY = "test-key"
SECRET = "portal-test-secret"
SERVERS = {"port": server_mod, "jax": jserver}


def png_bytes(size=32, value=255) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.full((size, size), value, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(autouse=True)
def no_pauses(monkeypatch):
    sleeps = []
    monkeypatch.setattr(client_mod, "CHUNK_DELAY_S", 0.0)
    monkeypatch.setattr(client_mod.time, "sleep", sleeps.append)
    return sleeps


@pytest.fixture()
def fake_portal():
    store = new_store()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(API_KEY, store))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}", store
    server.shutdown()
    server.server_close()


class _Quiet(WSGIRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture(params=sorted(SERVERS))
def live_portal(request, tmp_path):
    """One package's WSGI portal on an ephemeral port, JWT-secret mode."""
    app = SERVERS[request.param].create_app(tmp_path / "images", tmp_path / "annotations",
                                            secret_key=SECRET)
    server = make_server("127.0.0.1", 0, app, handler_class=_Quiet)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}", tmp_path
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def token() -> str:
    return jwt_auth.encode({"sub": "pipeline"}, SECRET, expires_in=300)


def http(url, method="GET", body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def save_annotation(url, image_name, mask_png, user="u1a2"):
    body = json.dumps({"image_name": image_name, "user_hash": user,
                       "mask": "data:image/png;base64," + base64.b64encode(mask_png).decode()})
    return http(f"{url}/save_annotation", "POST", body.encode(),
                {"Content-Type": "application/json"})


# --- the client against the fake portal ---------------------------------------

def test_upload_in_chunks_of_two_and_status(fake_portal, tmp_path):
    url, store = fake_portal
    client = PortalClient(url, API_KEY)
    paths = []
    for i in range(5):
        paths.append(tmp_path / f"nj000{i}_inpainted_colored.png")
        paths[-1].write_bytes(png_bytes(value=10 * i))
    assert client.upload_batch("NJ00", paths + [tmp_path / "missing.png"])
    assert sorted(store["images"]) == sorted(f"NJ00_{p.name}" for p in paths)
    assert store["images"][f"NJ00_{paths[3].name}"] == paths[3].read_bytes()
    status = client.get_annotation_status("NJ00")
    assert status["total_images"] == 5 and not status["completed"]
    assert not client.upload_batch("NJ00", [tmp_path / "missing.png"])


def test_upload_chunks_are_two_files_a_request(monkeypatch, tmp_path):
    bodies = []
    monkeypatch.setattr(client_mod, "request", lambda m, u, h, body, t: bodies.append(body))
    paths = [tmp_path / f"t{i}.png" for i in range(3)]
    for p in paths:
        p.write_bytes(png_bytes())
    assert PortalClient("http://127.0.0.1:1", API_KEY).upload_batch("NJ00", paths)
    assert [b.count(b'name="files"') for b in bodies] == [2, 1]


def test_fetch_and_delete_annotations(fake_portal, tmp_path):
    url, store = fake_portal
    for n in ("NJ00_nj0001_user_mask.png", "NJ00_nj0002_user_mask.png", "SU12_su0001_u_mask.png"):
        store["annotations"][n] = png_bytes(value=len(n))
    client = PortalClient(url, API_KEY)
    files = client.fetch_annotations("NJ00", download_dir=tmp_path)
    assert sorted(f.name for f in files) == ["NJ00_nj0001_user_mask.png",
                                              "NJ00_nj0002_user_mask.png"]
    assert all(f.parent == tmp_path / "NJ00" for f in files)
    assert files[0].read_bytes() == store["annotations"][files[0].name]
    assert client.delete_annotation("NJ00", "NJ00_nj0001_user_mask.png", confirm=False)
    assert not client.delete_annotation("NJ00", "NJ00_nj0001_user_mask.png", confirm=False)
    assert client.delete_processed_annotations("NJ00", ["NJ00_nj0002_user_mask.png"],
                                               confirm=False) == 1
    assert sorted(store["annotations"]) == ["SU12_su0001_u_mask.png"]


def test_feedback_and_probe_upload(fake_portal):
    url, store = fake_portal
    client = PortalClient(url, API_KEY)
    assert client.submit_feedback("NJ00", {"quality": "good"})
    assert store["feedback"] == [{"quality": "good"}]
    assert client.create_test_file("NJ00")
    assert "NJ00_portal_test.png" in store["images"]


def test_a_wrong_key_fails_every_call(fake_portal, tmp_path):
    url, _ = fake_portal
    client = PortalClient(url, "wrong-key")
    assert client.get_annotation_status("NJ00") is None
    assert client.fetch_annotations("NJ00", tmp_path) is None
    assert not client.submit_feedback("NJ00", {})
    assert client.delete_processed_annotations("NJ00", ["x"], confirm=False) == 0


def test_deletion_asks_unless_experiment_mode(fake_portal, monkeypatch):
    url, store = fake_portal
    store["annotations"]["NJ00_a_mask.png"] = b"x"
    client = PortalClient(url, API_KEY)
    monkeypatch.delenv("EXPERIMENT_MODE", raising=False)
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert client.delete_processed_annotations("NJ00", ["NJ00_a_mask.png"]) == 0
    assert not client.delete_annotation("NJ00", "NJ00_a_mask.png")
    monkeypatch.setenv("EXPERIMENT_MODE", "true")
    assert portal.experiment_mode()
    assert client.delete_processed_annotations("NJ00", ["NJ00_a_mask.png"]) == 1


# --- retries ---------------------------------------------------------------

class Scripted(BaseHTTPRequestHandler):
    """Answers each request with the next status of ``script``."""

    script: list = []
    seen: list = []

    def log_message(self, *args):
        pass

    def _answer(self):
        self.seen.append((self.command, self.path))
        code = self.script.pop(0) if self.script else 200
        body = json.dumps({"annotations": [], "deleted": 1}).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_DELETE = _answer


@pytest.fixture()
def scripted():
    Scripted.script, Scripted.seen = [], []
    server = ThreadingHTTPServer(("127.0.0.1", 0), Scripted)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("method", ["GET", "POST", "DELETE"])
def test_a_503_is_retried_with_urllib3s_backoff(scripted, no_pauses, method):
    Scripted.script = [503, 503, 503, 200]
    assert json.loads(client_mod.request(method, f"{scripted}/api/status/NJ00", {}))
    assert len(Scripted.seen) == 4 and {m for m, _ in Scripted.seen} == {method}
    assert no_pauses == [0.0, 2.0, 4.0]


@pytest.mark.parametrize("code", [400, 401, 404])
def test_a_client_error_is_not_retried(scripted, no_pauses, code):
    Scripted.script = [code, 200]
    with pytest.raises(urllib.error.HTTPError) as info:
        client_mod.request("GET", f"{scripted}/api/status/NJ00", {})
    assert info.value.code == code and len(Scripted.seen) == 1 and no_pauses == []


def test_retries_end_after_five(scripted, no_pauses):
    Scripted.script = [502] * 7
    with pytest.raises(urllib.error.HTTPError):
        client_mod.request("GET", f"{scripted}/x", {})
    assert len(Scripted.seen) == 6
    # through the client: the script's last 502, then its 200
    assert PortalClient(scripted, API_KEY).get_annotation_status("NJ00") == {
        "annotations": [], "deleted": 1}


def test_backoff_is_urllib3s_at_factor_one():
    from urllib3.util.retry import RequestHistory, Retry

    retry = Retry(total=client_mod.RETRIES, backoff_factor=client_mod.BACKOFF_FACTOR)
    for n in range(1, client_mod.RETRIES + 1):
        retry = retry.new(history=retry.history + (RequestHistory("GET", "/", None, 503, None),))
        assert client_mod.backoff_s(n) == retry.get_backoff_time(), n
    assert set(client_mod.RETRY_STATUSES) == {429, 500, 502, 503, 504}


def test_a_refused_connection_is_retried(no_pauses):
    with pytest.raises(urllib.error.URLError):
        client_mod.request("GET", "http://127.0.0.1:1/api/status/NJ00", {}, timeout=2)
    assert len(no_pauses) == client_mod.RETRIES


# --- the client and the annotator's posts against both WSGI servers ----------------

def test_jwt_bearer_and_its_401s(live_portal):
    url, _ = live_portal
    assert PortalClient(url, token()).get_annotation_status("NJ05")["total_images"] == 0
    status, body = http(f"{url}/api/status/NJ05")
    assert status == 401 and json.loads(body)["error"] == "No API key provided"
    status, body = http(f"{url}/api/status/NJ05", headers={"Authorization": "Bearer nope"})
    assert status == 401 and json.loads(body)["error"] == "Invalid API key"
    expired = jwt_auth.encode({"sub": "x"}, SECRET, expires_in=-10)
    assert PortalClient(url, expired).get_annotation_status("NJ05") is None
    assert PortalClient(url, jwt_auth.encode({}, "other")).fetch_annotations("NJ05") is None
    assert http(f"{url}/")[0] == 200 and http(f"{url}/static/annotator.js")[0] == 200


def test_upload_prefixes_the_grid_and_images_are_listed(live_portal, tmp_path):
    url, root = live_portal
    files = [tmp_path / "colored_nj0957.png", tmp_path / "NJ05_colored_nj0958.png"]
    for f in files:
        f.write_bytes(png_bytes(value=7))
    assert PortalClient(url, token()).upload_batch("NJ05", files)
    names = ["NJ05_colored_nj0957.png", "NJ05_colored_nj0958.png"]
    assert sorted(p.name for p in (root / "images").iterdir()) == names
    assert (root / "images" / names[0]).read_bytes() == files[0].read_bytes()
    assert json.loads(http(f"{url}/images")[1])["images"] == names
    status, body = http(f"{url}/api/upload/NJ05", "POST", b"",
                        {"Authorization": f"Bearer {token()}"})
    assert status == 400 and json.loads(body)["error"] == "No files provided"


def test_save_annotation_names_and_size_check(live_portal, tmp_path):
    url, root = live_portal
    tile = tmp_path / "colored_nj0957.png"
    tile.write_bytes(png_bytes(48))
    assert PortalClient(url, token()).upload_batch("NJ05", [tile])
    status, body = save_annotation(url, "NJ05_colored_nj0957.png", png_bytes(32))
    assert status == 400 and "Mask dimensions (32x32) do not match original image (48x48)" \
        in json.loads(body)["message"]
    assert save_annotation(url, "NJ05_colored_nj0957.png", png_bytes(48))[0] == 200
    assert [p.name for p in (root / "annotations").iterdir()] == [
        "NJ05_colored_nj0957_u1a2_mask.png"]
    bad = json.dumps({"image_name": "x.png", "mask": "not a data url"}).encode()
    assert http(f"{url}/save_annotation", "POST", bad)[0] == 400
    client = PortalClient(url, token())
    assert client.get_annotation_status("NJ05") == {
        "grid_square": "NJ05", "total_images": 1, "annotated_images": 1, "completed": True}


def test_fetch_feedback_and_delete_batch(live_portal, tmp_path):
    url, root = live_portal
    client = PortalClient(url, token())
    (root / "images" / "NJ05_colored_nj0957.png").write_bytes(png_bytes(16))
    for user in ("aa", "bb"):
        assert save_annotation(url, "NJ05_colored_nj0957.png", png_bytes(16, 9), user)[0] == 200
    got = client.fetch_annotations("NJ05", tmp_path / "dl")
    assert sorted(p.name for p in got) == ["NJ05_colored_nj0957_aa_mask.png",
                                           "NJ05_colored_nj0957_bb_mask.png"]
    assert got[0].read_bytes() == png_bytes(16, 9)
    assert client.submit_feedback("NJ05", {"ok": 1})
    assert json.loads((root / "annotations" / "NJ05_feedback.jsonl").read_text())["ok"] == 1
    assert client.delete_annotation("NJ05", got[0].name, confirm=False)
    assert client.delete_processed_annotations("NJ05", [got[1].name, "gone.png"],
                                               confirm=False) == 1
    assert client.fetch_annotations("NJ05", tmp_path / "dl2") == []


def test_a_body_over_64_mb_is_refused(live_portal):
    url, _ = live_portal
    req = urllib.request.Request(
        f"{url}/api/upload/NJ05", data=b"", method="POST",
        headers={"Authorization": f"Bearer {token()}",
                 "Content-Length": str(server_mod.MAX_CONTENT_LENGTH + 1)})
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=30)
    assert info.value.code == 413
    assert server_mod.MAX_CONTENT_LENGTH == jserver.MAX_CONTENT_LENGTH == 64 * 2**20


def test_unknown_routes_and_methods(live_portal):
    url, _ = live_portal
    assert http(f"{url}/nowhere")[0] == 404
    assert http(f"{url}/images", "POST", b"")[0] == 405


# --- helpers ------------------------------------------------------------------

@pytest.mark.parametrize("stem", [
    "NJ05_colored_nj0957_u1a2_mask", "colored_nm4927_user", "NS83_ns8030_inpainted",
    "nothing_here", "NJ0957_x", "ab12345_cd", "x_ab1234", "NJ05_nj09_7_mask",
])
def test_extract_tile_token_as_jax(stem):
    assert helpers.extract_tile_token(stem) == jhelpers.extract_tile_token(stem)


def hg_tree(root, grid="NJ05", tiles=("nj0957", "nj0958", "nj0959"), empty=()):
    rng = np.random.default_rng(2)
    raw = {"data": {"output_dir": str(root / "out"), "processed_dir": str(root / "proc")}}
    hdir = root / "out" / grid / "human_annotation_masks"
    test = root / "proc" / grid / "test"
    for d in (hdir, test / "masks", test / "images"):
        d.mkdir(parents=True, exist_ok=True)
    for t in tiles:
        Image.fromarray(rng.integers(0, 255, (32, 32), dtype=np.uint8)).save(
            test / "images" / f"{t}.png")
        Image.fromarray(((rng.random((32, 32)) > 0.4) * 255).astype(np.uint8)).save(
            test / "masks" / f"{t}_mask_resized.png")
        hm = np.zeros((32, 32), np.uint8) if t in empty else \
            ((rng.random((32, 32)) > 0.8) * 255).astype(np.uint8)
        Image.fromarray(hm).save(hdir / f"{grid}_colored_{t}_u1_mask.png")
    Image.fromarray(np.zeros((32, 32), np.uint8)).save(hdir / f"{grid}_colored_nj0999_u_mask.png")
    (test / "images" / f"{tiles[-1]}.png").unlink()  # matched masks, no image
    return raw


def test_matching_equals_jax(tmp_path):
    raw = hg_tree(tmp_path)
    ours = helpers.match_human_and_system_masks("NJ05", Config.from_dict(raw))
    theirs = jhelpers.match_human_and_system_masks("NJ05", JConfig.from_dict(raw))
    assert ours == theirs and [p["tile_name"] for p in ours] == ["nj0957", "nj0958"]
    assert helpers.match_human_and_system_masks("SU12", Config.from_dict(raw)) == []


@pytest.mark.parametrize("case", ["all_empty", "some_empty", "probe_of_10", "no_items"])
def test_validate_dataset_as_jax(tmp_path, case):
    n = {"probe_of_10": 12, "no_items": 0}.get(case, 3)
    tiles = tuple(f"nj{i:04d}" for i in range(n + 1))
    # probe_of_10: the first 10 empty, so every item is counted
    empty = {"all_empty": tiles, "some_empty": tiles[:1],
             "probe_of_10": tiles[:10], "no_items": ()}[case]
    raw = hg_tree(tmp_path, tiles=tiles, empty=empty)
    pairs = helpers.match_human_and_system_masks("NJ05", Config.from_dict(raw))
    ours = helpers.validate_dataset(DirectMatchDataset(pairs, size=32))
    assert ours == jhelpers.validate_dataset(JDirectMatchDataset(pairs, size=32))
    assert ours == (case in ("some_empty", "probe_of_10"))


def test_fetch_annotations_for_grid_then_match(fake_portal, tmp_path):
    url, store = fake_portal
    raw = hg_tree(tmp_path)
    hdir = tmp_path / "out" / "NJ05" / "human_annotation_masks"
    for p in hdir.iterdir():  # the annotations move to the portal
        store["annotations"][p.name] = p.read_bytes()
        p.unlink()
    cfg = Config.from_dict(raw)
    got = helpers.fetch_annotations_for_grid("NJ05", PortalClient(url, API_KEY), cfg)
    assert got == hdir and sorted(p.name for p in hdir.iterdir()) == sorted(store["annotations"])
    assert [p["tile_name"] for p in helpers.match_human_and_system_masks("NJ05", cfg)] == [
        "nj0957", "nj0958"]
    assert helpers.fetch_annotations_for_grid("SU12", PortalClient(url, API_KEY), cfg) is None


def test_upload_results_and_its_cli(fake_portal, tmp_path, monkeypatch):
    url, store = fake_portal
    colored = tmp_path / "out" / "NJ00" / "colored"
    colored.mkdir(parents=True)
    for i in range(3):
        (colored / f"nj000{i}_inpainted_colored.png").write_bytes(png_bytes())
    raw = {"portal": {"base_url": url, "api_key": API_KEY},
           "data": {"output_dir": str(tmp_path / "out")}}
    assert upload_mod.upload_results("NJ00", Config.from_dict(raw))
    assert len(store["images"]) == 3
    assert not upload_mod.upload_results("SU12", Config.from_dict(raw))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.yaml").write_text(
        f"portal:\n  base_url: {url}\n  api_key: wrong\ndata:\n  output_dir: out\n")
    assert upload_mod.main(["--grid", "NJ00", "--config", "c.yaml", "--retry", "2"]) == 1


def test_pythonanywhere_client_as_jax(monkeypatch, tmp_path):
    FakePA.files = {"/home/u/ann/NJ00_nj0001_u_mask.png": b"png1",
                    "/home/u/ann/NJ00_nj0002_u_mask.png": b"png2",
                    "/home/u/ann/NX99_nx9901_u_mask.png": b"png3",
                    "/home/u/ann/notes.txt": b"x"}
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakePA)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    monkeypatch.setattr(pythonanywhere, "API_BASE",
                        f"http://127.0.0.1:{server.server_port}/api/v0/user/{{user}}")
    try:
        client = pythonanywhere.PythonAnywhereClient("u", TOKEN)
        got = client.download_annotations_for_grid("NJ00", "/home/u/ann", tmp_path)
        assert sorted(p.read_bytes() for p in got) == [b"png1", b"png2"]
        assert len(client.download_all("/home/u/ann", tmp_path / "all", max_workers=2)) == 4
        (tmp_path / "up").mkdir()
        (tmp_path / "up" / "NJ00_nj0003_u_mask.png").write_bytes(b"new")
        assert client.upload_annotations(tmp_path / "up", "/home/u/ann") == 1
        assert b"new" in FakePA.files["/home/u/ann/NJ00_nj0003_u_mask.png"]
        assert client.cleanup_remote("/home/u/ann", "NJ00") == 3
        assert not client.delete_file("/home/u/ann/none.png")
        with pytest.raises(RuntimeError, match="HTTP 401"):
            pythonanywhere.PythonAnywhereClient("u", "bad").list_tree("/home/u/ann")
    finally:
        server.shutdown()
        server.server_close()


def test_portal_package_exports_what_jax_exports(tmp_path):
    import terra_gan_tpu.portal as jportal

    assert portal.__all__ == jportal.__all__
    app = portal.create_server_app(tmp_path / "images", tmp_path / "annotations", api_key="k")
    assert isinstance(app, server_mod.PortalApp) and app.api_key == "k"
    assert (Path(server_mod.STATIC_DIR) / "index.html").read_bytes() == (
        Path(jserver.STATIC_DIR) / "index.html").read_bytes()
    assert (Path(server_mod.STATIC_DIR) / "annotator.js").read_bytes() == (
        Path(jserver.STATIC_DIR) / "annotator.js").read_bytes()
