"""The port's serving path (terra_gan_tpu_torch.serving) on the CPU.

The cases of tests/test_serving.py that apply to the port, with its
service at size 64, width 8, device="cpu": micro-batch coalescing and
error propagation, the live HTTP endpoints, bearer-JWT auth, the 413
and 400s, the graceful drain and the client. One checkpoint written
from JAX variables is served by both packages, whose PNGs agree within
one grey level.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from terra_gan_tpu.models import PConvUNet as JaxPConvUNet
from terra_gan_tpu.serving import InpaintService as JaxInpaintService
from terra_gan_tpu.utils.torch_compat import generator_vars_to_torch_state, save_pth
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import fused_pconv_eval
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.portal import jwt_auth
from terra_gan_tpu_torch.serving import (
    InpaintClient,
    InpaintService,
    MicroBatcher,
    ServingError,
    make_server,
)
from terra_gan_tpu_torch.serving import server as tserver
from terra_gan_tpu_torch.serving.client import main as client_main

SIZE = 64
SECRET = "serving-test-secret"


def service(**kw):
    return InpaintService(size=SIZE, out_size=SIZE, max_batch=4, base_width=8, device="cpu", **kw)


def png_b64(arr_u8: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def decode_png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))), np.int32)


def pair(seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size), dtype=np.uint8)
    mask = (rng.random((size, size)) > 0.3).astype(np.uint8) * 255
    return img, mask


def pair_payload(seed=0):
    img, mask = pair(seed)
    return {"image": png_b64(img), "mask": png_b64(mask)}


@pytest.fixture(scope="module")
def live():
    """(url of an open server, its service), and one with auth."""
    servers = []

    def start(**kw):
        svc = service()
        svc.warmup()
        srv = make_server(svc, "127.0.0.1", 0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_port}", svc

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def open_server(live):
    return live()


@pytest.fixture(scope="module")
def auth_server(live):
    return live(auth_secret=SECRET, max_body_bytes=256 * 1024, max_batch_items=4)


def request(url, payload=None, token=None, raw_body=None):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    data = raw_body if raw_body is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def token(**kw):
    return jwt_auth.encode({"sub": "tester"}, SECRET, **kw)


class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self):
        seen = []

        def infer(images, masks):
            seen.append(images.shape[0])
            time.sleep(0.02)  # the device is busy: the next requests queue up
            return images * 0.5

        mb = MicroBatcher(infer, max_batch=8, max_wait_ms=50)
        results = [None] * 6

        def worker(i):
            results[i] = mb.submit(np.full((4, 4, 1), float(i), np.float32),
                                   np.ones((4, 4, 1), np.float32))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert [float(r[0, 0, 0]) for r in results] == [i * 0.5 for i in range(6)]
        assert max(seen) > 1
        snap = mb.snapshot()
        assert snap["requests"] == 6 and snap["mean_batch"] > 1
        assert snap["latency_p95_ms"] >= snap["latency_p50_ms"] > 0
        assert snap["queue_depth"] == 0 and snap["inflight"] == 0

    def test_error_propagates(self):
        def infer(images, masks):
            raise ValueError("boom")

        mb = MicroBatcher(infer, max_batch=2, max_wait_ms=1)
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit(np.zeros((2, 2, 1), np.float32), np.ones((2, 2, 1), np.float32))
        assert mb.snapshot()["errors"] == 1


class TestHTTPService:
    def test_healthz_and_inpaint(self, open_server):
        url, _ = open_server
        code, _, body = request(f"{url}/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert health["devices"] == ["cpu"] and health["auth"] is False
        assert health["model_size"] == SIZE

        img, mask = pair(0)
        code, _, body = request(f"{url}/inpaint", {"image": png_b64(img), "mask": png_b64(mask)})
        got = decode_png(json.loads(body)["inpainted"])
        assert code == 200 and got.shape == (SIZE, SIZE)
        keep = mask > 0  # the composite keeps the valid pixels; uint8 allows one level
        assert np.abs(got[keep] - img[keep].astype(np.int32)).max() <= 1

        stats = json.loads(request(f"{url}/stats")[2])
        assert stats["requests"] >= 1 and stats["errors"] == 0
        assert stats["latency_p50_ms"] > 0
        assert stats["latency_p95_ms"] >= stats["latency_p50_ms"]
        assert stats["queue_depth"] == 0 and stats["inflight"] == 0

    def test_metrics_prometheus_exposition(self, open_server):
        url, _ = open_server
        request(f"{url}/inpaint", pair_payload(1))
        code, headers, body = request(f"{url}/metrics")
        assert code == 200 and headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        assert "# TYPE terra_gan_tpu_requests_total counter" in text
        values = dict(ln.split(" ", 1) for ln in text.strip().splitlines() if not ln.startswith("#"))
        assert float(values["terra_gan_tpu_requests_total"]) >= 1
        assert float(values["terra_gan_tpu_latency_p50_ms"]) > 0
        assert float(values["terra_gan_tpu_errors_total"]) == 0

    def test_batch_endpoint_and_missing_field(self, open_server):
        url, _ = open_server
        items = [pair_payload(i) for i in range(3)]
        code, _, body = request(f"{url}/inpaint_batch", {"items": items})
        outs = json.loads(body)["inpainted"]
        assert code == 200 and len(outs) == 3
        single = json.loads(request(f"{url}/inpaint", items[2])[2])["inpainted"]
        np.testing.assert_array_equal(decode_png(outs[2]), decode_png(single))
        code, _, body = request(f"{url}/inpaint", {"image": items[0]["image"]})
        assert code == 400 and "mask" in json.loads(body)["error"]

    def test_unknown_path_404(self, open_server):
        url, _ = open_server
        assert request(f"{url}/nope")[0] == 404
        assert request(f"{url}/nope", {"a": 1})[0] == 404


def test_uint8_upload_bit_identical_to_f32_path():
    """The stacked uint8 upload, normalised on the device, gives the same
    bytes as the model run on host-divided float32 inputs."""
    svc = InpaintService(size=32, out_size=32, max_batch=2, base_width=8, device="cpu")
    rng = np.random.default_rng(3)
    xi = rng.integers(0, 255, (1, 32, 32, 1), dtype=np.uint8)
    mi = (rng.random((1, 32, 32, 1)) > 0.3).astype(np.uint8)
    x = torch.from_numpy(xi.astype(np.float32) / 255.0)
    m = torch.from_numpy(mi.astype(np.float32))
    with torch.inference_mode():
        want = (svc.generator(x * m, m).clamp(0.0, 1.0) * 255.0).to(torch.uint8).numpy()
    np.testing.assert_array_equal(svc._infer(xi, mi), want)


def test_buckets_pad_and_warmup_runs_each():
    svc = InpaintService(size=32, out_size=32, max_batch=8, base_width=8, device="cpu")
    assert svc._buckets == [1, 2, 8]
    assert [svc._bucket(n) for n in (1, 2, 3, 8, 9)] == [1, 2, 8, 8, 8]
    seen = []
    forward = svc._forward
    svc._forward = lambda t: (seen.append(t.shape[0]), forward(t))[1]
    svc.warmup()
    rng = np.random.default_rng(0)
    out = svc._infer(rng.integers(0, 255, (3, 32, 32, 1), dtype=np.uint8),
                     np.ones((3, 32, 32, 1), np.uint8))
    assert seen == [1, 2, 8, 8] and out.shape == (3, 32, 32, 1) and out.dtype == np.uint8


def test_fused_tail_service_matches_and_launches_nothing_on_cpu():
    """The service's fused tail on the CPU takes K3's plain version: the
    same bytes as the unfused tail, and no kernel launch."""
    rng = np.random.default_rng(4)
    xi = rng.integers(0, 255, (2, SIZE, SIZE, 1), dtype=np.uint8)
    mi = (rng.random((2, SIZE, SIZE, 1)) > 0.3).astype(np.uint8)
    svc = service()
    before = fused_decoder_tail.launches
    got = svc._infer(xi, mi)
    x = torch.from_numpy(xi.astype(np.float32) / 255.0)
    m = torch.from_numpy(mi.astype(np.float32))
    g = svc.generator
    with torch.inference_mode():
        h, hm = g.decode(x * m, m, fused_pconv_eval, upsample2x_bilinear)
        y = g.tail_forward(h, hm, x * m, m, fused_pconv_eval, upsample2x_bilinear)
    np.testing.assert_array_equal(got, (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).numpy())
    assert fused_decoder_tail.launches == before


def test_output_is_resized_to_out_size():
    svc = InpaintService(size=SIZE, out_size=50, max_batch=1, base_width=8, device="cpu")
    img, mask = pair(5)
    image, m = svc.decode_pair({"image": png_b64(img), "mask": png_b64(mask)})
    assert image.shape == m.shape == (SIZE, SIZE, 1) and set(np.unique(m)) <= {0, 1}
    out = decode_png(svc.encode_output(svc._infer(image[None], m[None])[0]))
    assert out.shape == (50, 50)
    small = svc.decode_pair({"image": png_b64(img[:40, :40]), "mask": png_b64(mask[:40, :40])})
    assert small[0].shape == (SIZE, SIZE, 1)  # resized up to the model's size


class TestServingAuthAndHardening:
    def test_healthz_open_without_token(self, auth_server):
        url, _ = auth_server
        code, _, body = request(f"{url}/healthz")
        assert code == 200 and json.loads(body)["auth"] is True

    @pytest.mark.parametrize("path", ["/inpaint", "/stats", "/metrics"])
    def test_missing_token_401(self, auth_server, path):
        url, _ = auth_server
        code, _, body = request(f"{url}{path}", pair_payload() if path == "/inpaint" else None)
        assert code == 401 and "token" in json.loads(body)["error"]

    def test_tampered_token_401(self, auth_server):
        url, _ = auth_server
        good = token()
        bad = good[:-2] + ("AA" if not good.endswith("AA") else "BB")
        code, _, body = request(f"{url}/inpaint", pair_payload(), token=bad)
        assert code == 401 and "invalid token" in json.loads(body)["error"]

    def test_expired_token_401(self, auth_server):
        url, _ = auth_server
        code, _, body = request(f"{url}/inpaint", pair_payload(), token=token(expires_in=-10))
        assert code == 401 and "expired" in json.loads(body)["error"]

    def test_valid_token_inpaints_and_reads_stats(self, auth_server):
        url, _ = auth_server
        code, _, body = request(f"{url}/inpaint", pair_payload(), token=token())
        assert code == 200 and "inpainted" in json.loads(body)
        assert request(f"{url}/stats", token=token())[0] == 200

    def test_oversized_body_413(self, auth_server):
        url, _ = auth_server
        big = b'{"image": "' + b"A" * (300 * 1024) + b'"}'
        code, _, body = request(f"{url}/inpaint", raw_body=big, token=token())
        assert code == 413 and "exceeds" in json.loads(body)["error"]

    @pytest.mark.parametrize("path,raw,payload,needle", [
        ("/inpaint", b"{not json", None, "bad json"),
        ("/inpaint", b"[1,2,3]", None, "object"),
        ("/inpaint", None, {"image": png_b64(np.zeros((SIZE, SIZE), np.uint8)),
                            "mask": base64.b64encode(b"not a png").decode()}, "undecodable mask"),
        ("/inpaint", None, {"image": 12345, "mask": png_b64(np.zeros((SIZE, SIZE), np.uint8))},
         "base64"),
        ("/inpaint_batch", None, {"items": "nope"}, "list"),
        ("/inpaint_batch", None, {"items": [{"image": "x", "mask": "y"}] * 5}, "at most"),
        ("/inpaint_batch", None, {"items": [7]}, "JSON object"),
    ])
    def test_bad_requests_400(self, auth_server, path, raw, payload, needle):
        url, _ = auth_server
        code, _, body = request(f"{url}{path}", payload, token=token(), raw_body=raw)
        assert code == 400 and needle in json.loads(body)["error"]


def test_shutdown_finishes_inflight_then_refuses():
    """The drain the CLI wires to SIGTERM/SIGINT: an in-flight request
    completes with a 200; new connections are refused once drained."""
    svc = service()
    srv = make_server(svc, "127.0.0.1", 0)
    srv.daemon_threads = False  # as the CLI sets before serving
    port = srv.server_port
    submit = svc.batcher.submit

    def slow_submit(*a, **k):
        time.sleep(0.7)  # holds the request in flight past shutdown
        return submit(*a, **k)

    svc.batcher.submit = slow_submit
    serve = threading.Thread(target=srv.serve_forever)
    serve.start()
    result = {}

    def call():
        result["code"], _, result["body"] = request(f"http://127.0.0.1:{port}/inpaint",
                                                    pair_payload())

    rt = threading.Thread(target=call)
    rt.start()
    time.sleep(0.25)
    srv.shutdown()
    serve.join(10)
    srv.server_close()  # joins the in-flight handler thread
    rt.join(10)
    assert result.get("code") == 200 and "inpainted" in json.loads(result["body"])
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


@pytest.mark.parametrize("flag", [["--bf16"], ["--quant", "w8a8"], ["--calib-dir", "x"],
                                  ["--exported", "x.shlo"]])
def test_cli_refuses_what_is_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tserver.main(flag + ["--device", "cpu"])
    assert exc.value.code == 2 and "not ported yet" in capsys.readouterr().err


def test_service_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InpaintService(size=32, base_width=8)


class TestInpaintClient:
    def test_roundtrip_with_signed_auth(self, auth_server):
        url, _ = auth_server
        client = InpaintClient(url, auth_secret=SECRET)
        assert client.healthz()["status"] == "ok"
        img, mask = pair()
        out = client.inpaint(img, mask)
        assert out.shape == (SIZE, SIZE) and out.dtype == np.uint8
        keep = mask > 0
        assert np.abs(out[keep].astype(np.int32) - img[keep].astype(np.int32)).max() <= 1
        assert client.stats()["requests"] >= 1

    def test_batch_equals_singles(self, auth_server):
        url, _ = auth_server
        client = InpaintClient(url, auth_secret=SECRET)
        pairs = [pair(seed=i) for i in range(3)]
        for got, want in zip(client.inpaint_batch(pairs), [client.inpaint(*p) for p in pairs]):
            np.testing.assert_array_equal(got, want)

    def test_unauthorized_no_retry(self, auth_server):
        url, _ = auth_server
        with pytest.raises(ServingError, match="401"):
            InpaintClient(url, max_retries=3, backoff_s=5.0).inpaint(*pair())

    def test_retries_transient_503(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        hits = []

        class Flaky(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                hits.append(1)
                if len(hits) < 3:
                    self.send_response(503)
                    self.end_headers()
                    return
                body = json.dumps({"status": "ok"}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = HTTPServer(("127.0.0.1", 0), Flaky)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            client = InpaintClient(f"http://127.0.0.1:{srv.server_port}", max_retries=4,
                                   backoff_s=0.01)
            assert client.healthz()["status"] == "ok" and len(hits) == 3
        finally:
            srv.shutdown()
            srv.server_close()

    def test_terminal_connection_error(self):
        client = InpaintClient("http://127.0.0.1:1", max_retries=1, backoff_s=0.01)
        with pytest.raises(ServingError, match="after 2 attempts"):
            client.healthz()

    def test_files_and_cli_remote_batch(self, auth_server, tmp_path):
        url, _ = auth_server
        img_dir, mask_dir, out_dir = tmp_path / "images", tmp_path / "masks", tmp_path / "out"
        img_dir.mkdir(), mask_dir.mkdir()
        for i in range(3):
            img, mask = pair(seed=i)
            Image.fromarray(img).save(img_dir / f"t{i}.png")
            Image.fromarray(mask).save(mask_dir / f"t{i}_mask_resized.png")
        rc = client_main(["--url", url, "--images", str(img_dir), "--masks", str(mask_dir),
                          "--out", str(out_dir), "--secret", SECRET, "--batch", "2"])
        assert rc == 0
        outs = sorted(out_dir.glob("*_inpainted.png"))
        assert [p.name for p in outs] == [f"t{i}_inpainted.png" for i in range(3)]
        one = InpaintClient(url, auth_secret=SECRET).inpaint_files(
            img_dir / "t0.png", mask_dir / "t0_mask_resized.png", tmp_path / "one" / "t0.png")
        np.testing.assert_array_equal(np.asarray(Image.open(one)), np.asarray(Image.open(outs[0])))


def test_jwt_copy_matches_the_jax_helper():
    from terra_gan_tpu.portal import jwt_auth as jax_jwt

    claims = {"sub": "tester", "n": 3}
    tok = jwt_auth.encode(claims, SECRET)
    assert tok == jax_jwt.encode(claims, SECRET)
    assert jax_jwt.decode(tok, SECRET) == jwt_auth.decode(tok, SECRET) == claims
    with pytest.raises(jwt_auth.InvalidTokenError, match="signature"):
        jwt_auth.decode(tok, "other-secret")
    with pytest.raises(jwt_auth.InvalidTokenError, match="not yet valid"):
        jwt_auth.decode(jwt_auth.encode({"nbf": time.time() + 60}, SECRET), SECRET)


def test_jax_checkpoint_serves_the_same_pngs_in_both_packages(tmp_path):
    """One checkpoint written from JAX variables, one request through the
    port's service and the JAX service in fp32: PNGs within 1 grey level."""
    g = JaxPConvUNet(base_width=8)
    z = jnp.zeros((1, SIZE, SIZE, 1))
    v = jax.jit(g.init, static_argnums=3)(jax.random.PRNGKey(3), z, z + 1, False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
    rng = np.random.default_rng(7)
    for blk, stats in v["batch_stats"].items():  # statistics the eval forward reads
        c = stats["bn"]["mean"].shape[0]
        stats["bn"]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        stats["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    path = tmp_path / "master.pth"
    save_pth(path, {"generator_state_dict": generator_vars_to_torch_state(v)})
    port = InpaintService(checkpoint=str(path), size=SIZE, out_size=50, max_batch=2,
                          base_width=8, device="cpu")
    ref = JaxInpaintService(checkpoint=str(path), size=SIZE, out_size=50, max_batch=2,
                            bf16=False, base_width=8)
    payload = pair_payload(8)
    outs = []
    for svc in (port, ref):
        image, mask = svc.decode_pair(payload)
        outs.append(decode_png(svc.encode_output(svc._infer(image[None], mask[None])[0])))
    assert outs[0].shape == outs[1].shape == (50, 50)
    assert np.abs(outs[0] - outs[1]).max() <= 1
