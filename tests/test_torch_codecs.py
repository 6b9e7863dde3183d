"""The PyTorch package's PNG codec (flyimg_tpu_torch/codecs/png.py) against
Pillow: decode of gray, gray+alpha, RGB and RGBA PNGs written with each of
the five row filters, decode of Pillow's own (adaptively filtered) PNGs,
and encode -> Pillow decode round trips. Bound: exact."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.exceptions import UnsupportedMediaException

torch.set_num_threads(1)

MODES = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4)}


def _filter_rows(raw: np.ndarray, ftype: int, bpp: int) -> bytes:
    """Filter [h, stride] u8 rows with one PNG filter type (spec section 9)."""
    h, stride = raw.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        cur = raw[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prev
        elif ftype == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(ftype)
        out += (f & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _png(pixels: np.ndarray, color: int, ftype: int) -> bytes:
    h, w, ch = pixels.shape

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    raw = _filter_rows(pixels.reshape(h, w * ch), ftype, ch)
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("ftype", range(5))
def test_decode_each_row_filter_against_pillow(mode, ftype):
    color, ch = MODES[mode]
    rng = np.random.default_rng(ftype * 7 + ch)
    pixels = rng.integers(0, 256, (19, 23, ch)).astype(np.uint8)
    data = _png(pixels, color, ftype)
    rgb, alpha = png.decode(data)
    ref = _pil_rgba(data)
    np.testing.assert_array_equal(rgb, ref[..., :3])
    if ch in (2, 4):
        np.testing.assert_array_equal(alpha, ref[..., 3])
    else:
        assert alpha is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_pillow_saved_pngs(mode):
    _color, ch = MODES[mode]
    rng = np.random.default_rng(ch)
    yy, xx = np.mgrid[0:41, 0:57]
    arr = ((yy * 5 + xx * 3)[..., None] + rng.integers(0, 20, (41, 57, ch))) % 256
    arr = arr.astype(np.uint8)
    im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=True)
    decoded = codecs.decode(buf.getvalue())
    ref = _pil_rgba(buf.getvalue())
    np.testing.assert_array_equal(decoded.rgb, ref[..., :3])
    assert decoded.size == (57, 41) and decoded.mime == "image/png"


@pytest.mark.parametrize("with_alpha", [False, True])
def test_encode_round_trips_through_pillow(with_alpha):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    alpha = rng.integers(0, 256, (37, 53)).astype(np.uint8) if with_alpha else None
    data = codecs.encode(rgb, "png", alpha)
    im = Image.open(io.BytesIO(data))
    assert im.mode == ("RGBA" if with_alpha else "RGB")
    back = np.asarray(im)
    np.testing.assert_array_equal(back[..., :3], rgb)
    if with_alpha:
        np.testing.assert_array_equal(back[..., 3], alpha)
    got_rgb, got_alpha = png.decode(data)
    np.testing.assert_array_equal(got_rgb, rgb)


@pytest.mark.parametrize("case", ["palette", "16bit", "interlaced", "jpeg"])
def test_unsupported_inputs_raise(case):
    if case == "jpeg":
        buf = io.BytesIO()
        Image.new("RGB", (8, 8)).save(buf, "JPEG")
        with pytest.raises(UnsupportedMediaException):
            codecs.decode(buf.getvalue())
        with pytest.raises(UnsupportedMediaException):
            codecs.encode(np.zeros((4, 4, 3), np.uint8), "jpg")
        return
    buf = io.BytesIO()
    if case == "palette":
        Image.new("P", (8, 8)).save(buf, "PNG")
    elif case == "16bit":
        Image.fromarray(np.zeros((8, 8), np.uint16)).save(buf, "PNG")
    else:  # Adam7: Pillow does not write it, so set the IHDR flag by hand
        data = bytearray(_png(np.zeros((8, 8, 3), np.uint8), 2, 0))
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        buf = io.BytesIO(bytes(data))
    with pytest.raises(UnsupportedMediaException):
        png.decode(buf.getvalue())
