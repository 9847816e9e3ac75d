"""The port's mask detectors without OpenCV, held to cv2 and to the JAX detectors.

Each OpenCV primitive the JAX detectors call has a PyTorch (or, for the
sequential parts, numpy) counterpart in
``terra_gan_tpu_torch.data.mask_processing.cv_ops``. Where OpenCV's
operation is exact the port must give equal pixels: the colour
conversions, inRange, morphology, the min-max normalise, the nearest
resize, the thick line, the filled external contours (on shapes built to
cross ``min_area``, a k x k square at the threshold among them) and the
probabilistic Hough lines on the same edges. Elsewhere the tolerance is
stated: CLAHE and the bilateral filter within 1 grey level on 99 % of
pixels, Canny's edges IoU 0.95, the adaptive threshold IoU 0.99. The
detectors run on the CPU here against the JAX package's on one decoded
BGR array of structured aerial-like images (256^2, 512^2, 300x257):
vegetation and fields IoU 0.98, roads 0.85, the combined mask 0.95,
buildings equal (empty).
"""

from __future__ import annotations

import io
import logging

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from terra_gan_tpu.data.mask_processing import pipeline as jpipe
from terra_gan_tpu_torch.data.mask_processing import cv_ops
from terra_gan_tpu_torch.data.mask_processing import detectors as tdet
from terra_gan_tpu_torch.data.mask_processing import pipeline as tpipe

SHAPES = ((256, 256), (512, 512), (300, 257))
ROAD = (182, 184, 180)
DETECTOR_IOU = {"roads": 0.85, "vegetation": 0.98, "fields": 0.98, "combined": 0.95}


def aerial(h: int, w: int, seed: int) -> np.ndarray:
    """A BGR aerial-like tile: textured ground, a block of dark furrows (a
    ploughed field), green patches, diagonal and near-axis roads."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.integers(60, 120, (h, w, 3), dtype=np.uint8)
    field = (yy >= h // 8) & (yy < h * 5 // 8) & (xx >= w // 2) & (xx < w * 15 // 16)
    img[field & (yy % 10 < 6)] = (35, 45, 50)
    img[((yy // 90 + xx // 80) % 3 == 0) & ~field] = (40, 140, 50)
    img[np.abs(yy - xx) % 97 < 3] = ROAD
    img[np.abs(yy - h // 2 - (xx * 0.14).astype(int)) < 4] = ROAD
    img[np.abs(xx - w // 5 - (yy * 0.1).astype(int)) < 4] = ROAD
    return img


def jpeg_bytes(bgr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.fixture(scope="module")
def decoded():
    """Each shape's tile as a JPEG, decoded once by cv2 (the JAX reader)."""
    out = {}
    for i, (h, w) in enumerate(SHAPES):
        data = jpeg_bytes(aerial(h, w, 100 + i))
        out[(h, w)] = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return out


@pytest.fixture(scope="module")
def masks(decoded):
    """Both packages' masks for each decoded tile, by MaskType value."""
    jp, tp = jpipe.MaskPipeline(), tpipe.MaskPipeline(device="cpu")
    out = {}
    for shape, img in decoded.items():
        a, b = jp.process_image(img), tp.process_image(img)
        out[shape] = ({k.value: v for k, v in a.items()}, {k.value: v for k, v in b.items()})
    return out


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def iou(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a > 0, b > 0
    union = np.count_nonzero(a | b)
    return 1.0 if union == 0 else np.count_nonzero(a & b) / union


def colours(n: int, seed: int) -> np.ndarray:
    v = np.random.default_rng(seed).integers(0, 256 ** 3, n).astype(np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        -1, 500, 3)


def gray_of(shape, decoded):
    return cv2.cvtColor(decoded[shape], cv2.COLOR_BGR2GRAY)


# -------------------------------------------------------------- colour ----

@pytest.mark.parametrize("case", ["colours", *SHAPES])
def test_gray_hsv_and_lab_l_equal_cv2(case, decoded):
    img = colours(200_000, 1) if case == "colours" else decoded[case]
    np.testing.assert_array_equal(cv_ops.bgr_to_gray(t(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    for got, c in zip(cv_ops.bgr_to_hsv(t(img)), range(3)):
        np.testing.assert_array_equal(got.numpy(), hsv[..., c])
    np.testing.assert_array_equal(cv_ops.bgr_to_lab_l(t(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2LAB)[..., 0])


@pytest.mark.parametrize("lo,hi", [((35, 50, 50), (85, 255, 255)), ((30, 40, 40), (90, 255, 255))])
def test_in_range_equals_cv2(lo, hi):
    img = colours(100_000, 2)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    want = cv2.inRange(hsv, np.array(lo), np.array(hi)) > 0
    got = cv_ops.in_range(cv_ops.bgr_to_hsv(t(img)), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


# ------------------------------------------------------ CLAHE, bilateral ----

@pytest.mark.parametrize("shape", [*SHAPES, (256, 300), (61, 40)])
def test_clahe_within_one_grey_level_of_cv2(shape, decoded):
    """Sides that are not multiples of 8 (one or both) take OpenCV's padding."""
    h, w = shape
    gray = cv2.cvtColor(decoded.get(shape, aerial(h, w, 7)), cv2.COLOR_BGR2GRAY)
    want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(gray)
    diff = np.abs(cv_ops.clahe(t(gray)).numpy().astype(int) - want)
    assert np.mean(diff <= 1) >= 0.99 and diff.max() <= 1, (np.count_nonzero(diff), diff.max())


@pytest.mark.parametrize("shape", SHAPES)
def test_bilateral_within_one_grey_level_of_cv2(shape, decoded):
    for src in (gray_of(shape, decoded), cv2.cvtColor(decoded[shape], cv2.COLOR_BGR2LAB)[..., 0]):
        want = cv2.bilateralFilter(src, 9, 75, 75)
        diff = np.abs(cv_ops.bilateral_filter(t(src), 9, 75, 75).numpy().astype(int) - want)
        assert np.mean(diff <= 1) >= 0.99, (np.count_nonzero(diff), diff.max())


# --------------------------------------------------------------- Canny ----

@pytest.mark.parametrize("shape", SHAPES)
def test_canny_edges_iou_with_cv2(shape, decoded):
    smooth = cv2.bilateralFilter(cv2.createCLAHE(2.0, (8, 8)).apply(gray_of(shape, decoded)),
                                 9, 75, 75)
    want = cv2.Canny(smooth, 150, 300)
    got = cv_ops.canny(t(smooth), 150, 300).numpy()
    assert want.any() and iou(got, want) >= 0.95


def test_hysteresis_follows_a_long_weak_chain():
    """A weak spiral 8-connected to one strong pixel is kept whole, however
    many dilation rounds it takes; a weak pixel off the chain is not."""
    weak = np.zeros((40, 40), bool)
    weak[5, 5:35] = weak[5:35, 34] = weak[34, 5:35] = weak[8:35, 5] = True
    weak[8, 5:30] = True
    weak[20, 20] = True
    strong = np.zeros_like(weak)
    strong[8, 29] = True
    got = cv_ops.hysteresis(t(strong), t(weak), rounds=4).numpy()
    want = weak.copy()
    want[20, 20] = False
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_hough_lines_equal_cv2_on_the_same_edges(shape, decoded):
    smooth = cv2.bilateralFilter(cv2.createCLAHE(2.0, (8, 8)).apply(gray_of(shape, decoded)),
                                 9, 75, 75)
    edges = cv2.Canny(smooth, 150, 300)
    for threshold, length, gap in ((100, 100, 20), (30, 20, 5)):
        want = cv2.HoughLinesP(edges, 1, np.pi / 180, threshold, minLineLength=length,
                               maxLineGap=gap)
        want = [] if want is None else [tuple(map(int, ln)) for ln in want.reshape(-1, 4)]
        # the CPU's chunk and the card's, and on the small tile a chunk of 37
        for chunk in (None, 8192) + ((37,) if shape == (256, 256) else ()):
            got = cv_ops.hough_lines_p(t(edges > 0), np.pi / 180, threshold, length, gap,
                                       cv_ops.CvRNG(tdet.HOUGH_SEED), chunk=chunk)
            assert got == want and len(want) > 0, chunk


def test_cv_rng_is_a_seeded_generator_of_its_own():
    a, b = cv_ops.CvRNG(5), cv_ops.CvRNG(5)
    draws = [a.uniform(0, 1000) for _ in range(50)]
    assert draws == [b.uniform(0, 1000) for _ in range(50)]
    assert draws != [cv_ops.CvRNG(6).uniform(0, 1000) for _ in range(50)]
    np.random.seed(0)
    before = np.random.get_state()[1].copy()
    cv_ops.hough_lines_p(t(np.eye(64, dtype=bool)), np.pi / 180, 10, 10, 2, cv_ops.CvRNG())
    np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_thick_lines_equal_cv2():
    rng = np.random.default_rng(3)
    for _ in range(300):
        x1, y1, x2, y2 = map(int, rng.integers(0, 80, 4))
        want = np.zeros((80, 90), np.uint8)
        cv2.line(want, (x1, y1), (x2, y2), 255, 3)
        got = np.zeros((80, 90), bool)
        cv_ops.draw_thick_line(got, x1, y1, x2, y2, 3)
        np.testing.assert_array_equal(got, want > 0, err_msg=str((x1, y1, x2, y2)))


# ------------------------------------------- morphology, threshold, resize ----

@pytest.mark.parametrize("k", [3, 5])
def test_morphology_equals_cv2(k):
    rng = np.random.default_rng(k)
    m = rng.random((97, 131)) > 0.55
    m[0, :] = m[:, -1] = True  # the border never erodes or dilates
    ker = np.ones((k, k), np.uint8)
    u8 = m.astype(np.uint8) * 255
    for op, fn in ((cv2.MORPH_CLOSE, cv_ops.morph_close), (cv2.MORPH_OPEN, cv_ops.morph_open),
                   (cv2.MORPH_DILATE, cv_ops.dilate), (cv2.MORPH_ERODE, cv_ops.erode)):
        np.testing.assert_array_equal(fn(t(m), k).numpy(), cv2.morphologyEx(u8, op, ker) > 0)


def test_minmax_normalise_equals_cv2(decoded):
    """cv2 computes x * scale + shift as one fused multiply-add; spans such
    as 510, where some values land exactly on an integer, show it."""
    rng = np.random.default_rng(4)
    planes = [2.0 * b[..., 1] - b[..., 2] - b[..., 0]
              for b in (img.astype(np.float64) for img in decoded.values())]
    for lo, hi in ((-510, 510), (-255, 255), (-100, 310), (0, 1), (7, 7)):
        planes.append(rng.integers(lo, hi + 1, (50, 60)).astype(np.float64))
        planes[-1][0, :2] = (lo, hi)
    for x in planes:
        want = cv2.normalize(x, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.minmax_normalize_u8(t(x.astype(np.int32))).numpy(),
                                      want)


@pytest.mark.parametrize("shape", SHAPES)
def test_adaptive_threshold_iou_with_cv2(shape, decoded):
    src = cv2.bilateralFilter(cv2.cvtColor(decoded[shape], cv2.COLOR_BGR2LAB)[..., 0], 9, 75, 75)
    want = cv2.adaptiveThreshold(src, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                 cv2.THRESH_BINARY_INV, 25, 3)
    got = cv_ops.adaptive_threshold_gaussian_inv(t(src), 25, 3).numpy()
    assert want.any() and iou(got, want) >= 0.99


@pytest.mark.parametrize("size", [(517, 123), (64, 64), (128, 100), (300, 257)])
def test_resize_nearest_equals_cv2(size, decoded):
    img = decoded[(300, 257)]
    np.testing.assert_array_equal(cv_ops.resize_nearest(img, *size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


# ------------------------------------------------------------ contours ----

def cv2_large_contours(mask: np.ndarray, min_area: float) -> np.ndarray:
    u8 = mask.astype(np.uint8) * 255
    contours, _ = cv2.findContours(u8, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    out = np.zeros_like(u8)
    for c in contours:
        if cv2.contourArea(c) > min_area:
            cv2.drawContours(out, [c], -1, 255, -1)
    return out > 0


@pytest.mark.parametrize("min_area", [0, 3, 20, 100, 400])
def test_large_contours_equal_cv2_on_blobs(min_area):
    for seed in range(40):
        rng = np.random.default_rng(seed)
        m = rng.random((90, 110)) > 0.5
        m = cv2.GaussianBlur(m.astype(np.uint8) * 255, (7, 7), 0) > 110
        np.testing.assert_array_equal(cv_ops.keep_large_contours(t(m), min_area).numpy(),
                                      cv2_large_contours(m, min_area))


@pytest.mark.parametrize("min_area,sizes", [(5000, (70, 71, 72, 73)),
                                            (10000, (100, 101, 102))])
def test_squares_at_min_area_decide_as_cv2(min_area, sizes):
    """A filled k x k square has contour area (k - 1)^2: 71^2 > 5000 passes
    at k = 72, not 71; 10000 = 100^2 needs k = 102."""
    for k in sizes:
        m = np.zeros((130, 140), bool)
        m[9: 9 + k, 20: 20 + k] = True
        got = cv_ops.keep_large_contours(t(m), min_area).numpy()
        np.testing.assert_array_equal(got, cv2_large_contours(m, min_area))
        assert got.any() == ((k - 1) ** 2 > min_area)


def test_components_just_above_and_below_min_area_decide_as_cv2():
    """Ring (its hole filled), diagonal pinch, a thin tail (no area), a
    notched square, a component inside another's hole, and one touching
    the image border, each near the threshold."""
    m = np.zeros((260, 260), bool)
    m[2:75, 2:75] = True
    m[20:50, 20:50] = False          # ring: hole counted and filled
    m[30:40, 30:40] = True           # island inside the hole
    m[100:171, 0:71] = True          # at the border, 70^2 = 4900
    m[170:171, 71:200] = True        # a 1-pixel tail adds no area
    m[5:76, 120:191] = True
    m[5, 120] = False                # a notch: 70^2 - 1/2
    m[76:147, 191:262 - 2] = True    # diagonal pinch to the notched square
    m[200:250, 100:150] = True
    for min_area in (4899, 4899.5, 4900, 4900.5, 5000, 5328, 5329, 9000):
        np.testing.assert_array_equal(cv_ops.keep_large_contours(t(m), min_area).numpy(),
                                      cv2_large_contours(m, min_area), err_msg=str(min_area))


# ----------------------------------------------------------- detectors ----

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["roads", "buildings", "vegetation", "fields", "combined"])
def test_detector_matches_jax(kind, shape, masks):
    jax_masks, port_masks = masks[shape]
    want, got = jax_masks[kind], port_masks[kind]
    assert got.dtype == np.uint8 and got.shape == want.shape == shape
    assert set(np.unique(got)) <= {0, 255}
    if kind == "buildings":
        np.testing.assert_array_equal(got, want)
        assert not got.any()
        return
    assert (want > 127).any(), f"{kind} found nothing on the {shape} tile"
    assert iou(got > 127, want > 127) >= DETECTOR_IOU[kind]


def test_jpeg_decoded_by_pil_as_cv2_does(tmp_path):
    """The port reads JPEGs with PIL, the JAX package with cv2.imread: the
    detectors above take one decoded array, and on these tiles both
    decoders give the same pixels."""
    for i, (h, w) in enumerate(SHAPES):
        path = tmp_path / f"t{i}.jpg"
        path.write_bytes(jpeg_bytes(aerial(h, w, 100 + i)))
        np.testing.assert_array_equal(tpipe.read_bgr(path), cv2.imread(str(path)))


def test_failed_detector_logs_and_returns_zeros(caplog):
    det = tdet.VegetationDetector(device="cpu")
    gray = np.zeros((32, 48), np.uint8)  # not a BGR image: the HSV step fails
    with caplog.at_level(logging.ERROR):
        out = det.detect(gray)
    assert out.shape == (32, 48) and not out.any()
    assert "vegetation detection failed" in caplog.text


def test_pipeline_takes_one_image_at_a_time_from_many_threads(tmp_path, decoded):
    """More threads than cores, a short switch interval: every batch result
    is the serial one (the detectors hold the device one image at a time)."""
    import sys

    img = np.ascontiguousarray(decoded[(300, 257)][:96, :128])
    pipe = tpipe.MaskPipeline(device="cpu", max_workers=16)
    want = pipe.process_image(img)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = pipe.process_batch([img] * 24)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 24
    for masks in got:
        for kind in tpipe.MaskType:
            np.testing.assert_array_equal(masks[kind], want[kind])


def test_pipeline_combines_and_resizes_as_jax(tmp_path, decoded):
    img = decoded[(300, 257)]
    path = tmp_path / "tile.jpg"
    cv2.imwrite(str(path), img)
    batch = tpipe.MaskPipeline(device="cpu", max_workers=2).process_batch([path, path])
    single = tpipe.MaskPipeline(device="cpu").process_image(tpipe.read_bgr(path))
    for got in batch:
        for kind in tpipe.MaskType:
            np.testing.assert_array_equal(got[kind], single[kind])
    parts = {k: single[k] for k in tpipe.PRIORITY}
    parts[tpipe.MaskType.FIELDS] = cv2.resize(parts[tpipe.MaskType.FIELDS], (100, 90),
                                              interpolation=cv2.INTER_NEAREST)
    jparts = {jpipe.MaskType(k.value): v for k, v in parts.items()}
    np.testing.assert_array_equal(tpipe.combine_masks(parts), jpipe.combine_masks(jparts))
    dem = tmp_path / "nj0101.png"
    Image.fromarray(np.zeros((64, 64), np.uint8)).save(dem)
    ours = tpipe.resize_mask_to_dem(single[tpipe.MaskType.COMBINED], dem, tmp_path / "a.png")
    theirs = jpipe.resize_mask_to_dem(single[tpipe.MaskType.COMBINED], dem, tmp_path / "b.png")
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), cv2.imread(str(theirs), 0))
