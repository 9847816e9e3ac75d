"""The port's inference path (BatchedInpainter, inpaint_directory, evaluate) on the CPU.

Held to itself (uint8 ingest and output against the float path, byte
for byte) and to the JAX package's counterparts within one grey level,
on 64^2 tiles with the same weights.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from terra_gan_tpu.evaluation import inference as jinf
from terra_gan_tpu.models import PConvUNet as JaxPConvUNet
from terra_gan_tpu.parallel.infer import BatchedInpainter as JaxBatchedInpainter
from terra_gan_tpu.parallel.mesh import make_mesh
from terra_gan_tpu.utils.torch_compat import generator_vars_to_torch_state, save_pth
from terra_gan_tpu_torch.evaluation import inference as tinf
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.utils import device as tdevice
from terra_gan_tpu_torch.utils.weights import generator_from_jax_variables

SIZE = 64


@pytest.fixture(scope="module")
def models():
    g = JaxPConvUNet(base_width=8)
    z = jnp.zeros((1, SIZE, SIZE, 1))
    v = jax.jit(g.init, static_argnums=3)(jax.random.PRNGKey(0), z, z + 1, False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
    rng = np.random.default_rng(0)
    for blk, stats in v["batch_stats"].items():
        c = stats["bn"]["mean"].shape[0]
        stats["bn"]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        stats["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return g, v, generator_from_jax_variables(v, 8, "cpu")


def u8_tiles(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    masks = np.where(rng.random((n, SIZE, SIZE, 1)) > 0.3, 255, 0).astype(np.uint8)
    masks[:, 8:30, 16:48] = 0
    return imgs, masks


def write_split(root, n: int, size: int = 80):
    rng = np.random.default_rng(1)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size), dtype=np.uint8)).save(
            root / "images" / f"ns{i:04d}.png")
        Image.fromarray(((rng.random((size, size)) > 0.3) * 255).astype(np.uint8)).save(
            root / "masks" / f"ns{i:04d}_mask_resized.png")


def max_diff(a, b) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_uint8_path_is_byte_identical_to_float_path(models):
    _, _, model = models
    imgs, masks = u8_tiles(5)
    xf = imgs.astype(np.float32) / 255.0
    mf = (masks > 0).astype(np.float32)
    out_u8 = BatchedInpainter(model, "cpu", chunk=2, quantize_uint8=True)(imgs, masks)
    out_f = BatchedInpainter(model, "cpu", chunk=2)(xf, mf)
    assert out_u8.dtype == np.uint8 and out_u8.shape == (5, SIZE, SIZE, 1)
    host_q = (np.clip(out_f, 0.0, 1.0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(out_u8, host_q)
    # float path fed u8 ingest: the device normalisation is the host's, bit for bit
    np.testing.assert_array_equal(BatchedInpainter(model, "cpu", chunk=2)(imgs, masks), out_f)


def test_batched_matches_jax_batched_inpainter(models):
    g, v, model = models
    imgs, masks = u8_tiles(8, seed=2)
    want = JaxBatchedInpainter(g, v, mesh=make_mesh(8), chunk=8, quantize_uint8=True)(imgs, masks)
    got = BatchedInpainter(model, "cpu", chunk=4, quantize_uint8=True)(imgs, masks)
    assert got.shape == want.shape and max_diff(got, want) <= 1


def test_stream_yields_each_chunk_after_the_next_is_dispatched(models):
    _, _, model = models
    imgs, masks = u8_tiles(3, seed=3)
    pulled = []

    def chunks():
        for i in range(3):
            pulled.append(i)
            yield i, imgs[i : i + 1], masks[i : i + 1]

    seen = []
    for meta, out in BatchedInpainter(model, "cpu", chunk=1).stream_from(chunks()):
        seen.append((meta, len(pulled)))
        assert out.shape == (1, SIZE, SIZE, 1)
    assert seen == [(0, 2), (1, 3), (2, 3)]
    empty = BatchedInpainter(model, "cpu", chunk=2, quantize_uint8=True)(imgs[:0], masks[:0])
    assert empty.shape == (0, SIZE, SIZE, 1) and empty.dtype == np.uint8


def test_inpaint_directory_matches_jax(models, tmp_path):
    g, v, model = models
    write_split(tmp_path, 5)
    (tmp_path / "images" / "bad.png").write_bytes(b"not a png")  # skipped
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "masks" / "bad_mask_resized.png")
    got = tinf.inpaint_directory(
        model, tmp_path / "images", tmp_path / "masks", tmp_path / "port",
        device="cpu", chunk=2, model_size=SIZE, out_size=100,
    )
    want = jinf.inpaint_directory(
        g, v, tmp_path / "images", tmp_path / "masks", tmp_path / "jax",
        chunk=8, model_size=SIZE, out_size=100,
    )
    assert [p.name for p in got] == [p.name for p in want] == [
        f"ns{i:04d}_inpainted.png" for i in range(5)]
    for a, b in zip(got, want):
        pa, pb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert pa.shape == (100, 100) and pa.dtype == np.uint8
        assert max_diff(pa, pb) <= 1


def test_inpaint_directory_retries_at_half_chunk_on_oom(models, tmp_path, monkeypatch):
    _, _, model = models
    write_split(tmp_path, 4)
    real = BatchedInpainter._dispatch
    chunks_seen = []

    def dispatch(self, images, masks):
        chunks_seen.append(self.chunk)
        if self.chunk == 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(self, images, masks)

    monkeypatch.setattr(BatchedInpainter, "_dispatch", dispatch)
    outs = tinf.inpaint_directory(
        model, tmp_path / "images", tmp_path / "masks", tmp_path / "out",
        device="cpu", chunk=4, model_size=SIZE, out_size=SIZE,
    )
    assert len(outs) == 4 and chunks_seen == [4, 2, 2]


def test_evaluate_matches_jax(models, tmp_path):
    g, v, model = models
    write_split(tmp_path, 1, size=120)
    img, mask = tmp_path / "images" / "ns0000.png", tmp_path / "masks" / "ns0000_mask_resized.png"
    ckpt = tmp_path / "g.pth"
    save_pth(ckpt, {"generator_state_dict": generator_vars_to_torch_state(v)})
    live = tinf.evaluate(img, mask, model, tmp_path / "live.png")
    from_ckpt = tinf.evaluate(img, mask, ckpt, tmp_path / "ckpt.png", device="cpu")
    # the JAX evaluate always runs the 512^2 model size, as the reference does
    want = jinf.evaluate(img, mask, g, tmp_path / "jax.png", variables=v)
    a, b, c = (np.asarray(Image.open(p)) for p in (live, from_ckpt, want))
    assert a.shape == (tinf.OUTPUT_SIZE, tinf.OUTPUT_SIZE) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert max_diff(a, c) <= 1


def test_evaluate_takes_the_device_from_the_model_or_an_explicit_one(models, tmp_path):
    """A live generator is not moved (device raises); a checkpoint needs a device."""
    _, v, model = models
    write_split(tmp_path, 1)
    img, mask = tmp_path / "images" / "ns0000.png", tmp_path / "masks" / "ns0000_mask_resized.png"
    ckpt = tmp_path / "g.pth"
    save_pth(ckpt, generator_vars_to_torch_state(v))
    with pytest.raises(ValueError, match="explicit device"):
        tinf.evaluate(img, mask, ckpt, tmp_path / "a.png")
    with pytest.raises(ValueError, match="where its parameters are"):
        tinf.evaluate(img, mask, model, tmp_path / "b.png", device="cpu")
    assert not (tmp_path / "a.png").exists() and not (tmp_path / "b.png").exists()


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        BatchedInpainter(torch.nn.Identity(), "cuda:0")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")
