"""The wire codec of the inpainting service, the benchmark's own copy of
the client's arithmetic (serving/client.py: PNG through PIL, base64 in
JSON), and the server's output contract for the reference: the uint8
tile resized to the output side with PIL's bilinear filter."""

from __future__ import annotations

import base64
import io
import json

import numpy as np
from PIL import Image


def png_b64(u8: np.ndarray) -> str:
    """A uint8 (H, W[, 1]) plane as base64 PNG."""
    if u8.ndim == 3:
        u8 = u8[..., 0]
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(u8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def decode_png_b64(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("L"), np.uint8)


def inpaint_body(image_u8: np.ndarray, mask_u8: np.ndarray) -> bytes:
    """The /inpaint request body; the mask as 0/255."""
    mask = ((mask_u8 > 0).astype(np.uint8) * 255)
    return json.dumps({"image": png_b64(image_u8), "mask": png_b64(mask)}).encode()


def served_answer(body: bytes) -> np.ndarray:
    """The uint8 plane of an /inpaint response body."""
    return decode_png_b64(json.loads(body)["inpainted"])


def output_contract(u8: np.ndarray, side: int) -> np.ndarray:
    """What the service returns for a uint8 tile: resized to ``side`` with
    PIL's bilinear filter where it differs."""
    if u8.ndim == 3:
        u8 = u8[..., 0]
    img = Image.fromarray(np.ascontiguousarray(u8))
    if u8.shape != (side, side):
        img = img.resize((side, side), Image.BILINEAR)
    return np.asarray(img, np.uint8)
