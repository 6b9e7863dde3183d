"""The PyTorch package's codecs on the CPU.

- PNG (flyimg_tpu_torch/codecs/png.py) against Pillow: decode of gray,
  gray+alpha, RGB and RGBA PNGs written with each of the five row filters,
  decode of Pillow's own (adaptively filtered) PNGs, and encode -> Pillow
  decode round trips; every colour type x bit depth x interlace (palette
  with and without tRNS, 1-16 bits, Adam7) against the JAX package's
  decode. Bound: exact.
- EXIF orientation 1-8 of PNG, JPEG and WebP sources against the JAX
  package's ``flyimg_tpu.codecs.decode``: shape, colour and alpha exact.
- JPEG: nvJPEG runs on a card only, so here the tests hold what surrounds
  it, with a Pillow stand-in for the two nvJPEG calls
  (tests/torch_jpeg_stand_in.py): the DCT prescale the target hint picks
  (scales 1, 2, 4 and 8 of 8; 4:2:0, 4:4:4 and progressive sources) and
  the encode options (q_, moz_, sf_), against the JAX package's decode and
  encode, exact; and ``parse_sampling_factor`` against the JAX function,
  every spelling and refusal. nvJPEG itself is held by the card's tests
  (tests/test_torch_codecs_card.py) and ``chip_smoke.py`` phase 10.
- WebP: the package's lossless (VP8L) encoder round trips exactly through
  Pillow's libwebp and its own decoder; its decoder gives the JAX
  package's pixels on Pillow's lossless files; a lossy request answers a
  lossy (VP8) file near the JAX package's; a lossy source decodes to the
  JAX package's pixels (tests/test_torch_webp.py holds the VP8 codec
  itself).
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import flyimg_tpu.codecs as jcodecs
import torch_jpeg_stand_in as stand_in
from flyimg_tpu.codecs.sniff import MediaInfo as JMediaInfo
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import native_codec, png
from flyimg_tpu_torch.codecs.sniff import MediaInfo
from flyimg_tpu_torch.exceptions import (
    InvalidArgumentException,
    UnsupportedMediaException,
)

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
def test_unsupported_inputs_raise(case, monkeypatch):
    """JPEG on the CPU is refused by name (nvJPEG runs on a card). The PNG
    cases (a palette PNG, a 16-bit gray PNG, an Adam7 PNG) once raised
    too: they now decode to the JAX package's pixels."""
    if case == "jpeg":
        # JPEG is nvJPEG's, on a CUDA device: on the CPU it is refused by
        # name; through the nvJPEG calls' stand-in it is the JAX
        # package's decode and encode
        buf = io.BytesIO()
        Image.fromarray(np.arange(192, dtype=np.uint8).reshape(8, 8, 3)).save(buf, "JPEG")
        with pytest.raises(UnsupportedMediaException, match="nvJPEG"):
            codecs.decode(buf.getvalue(), device="cpu")
        with pytest.raises(UnsupportedMediaException, match="nvJPEG"):
            codecs.encode(np.zeros((4, 4, 3), np.uint8), "jpg", device="cpu")
        stand_in.install(monkeypatch)
        got, ref = codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue())
        np.testing.assert_array_equal(got.rgb, ref.rgb)
        frame = np.zeros((4, 4, 3), np.uint8)
        assert codecs.encode(frame, "jpg") == jcodecs.encode(frame, "jpg")
        return
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    if case == "palette":
        Image.fromarray(rng.integers(0, 256, (8, 8), dtype=np.uint8), "P").save(buf, "PNG")
    elif case == "16bit":
        Image.fromarray(rng.integers(0, 400, (8, 8)).astype(np.uint16)).save(buf, "PNG")
    else:  # Adam7: Pillow does not write it, so set the IHDR flag by hand
        buf = io.BytesIO(_png_any(rng.integers(0, 256, (8, 8, 3)), 8, 2, interlace=1))
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


#: Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples -> [h, stride] u8 rows of the PNG's bit depth
    (big-endian, sub-byte samples packed from the high bit, rows padded)."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * ch).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    shifts = np.arange(depth - 1, -1, -1)
    bits = (samples.reshape(h, w * ch, 1) >> shifts) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_image(raw: np.ndarray, bpp: int, seed: int) -> bytes:
    """Filter each row with its own filter type, cycling through all five."""
    out = b""
    for y in range(raw.shape[0]):
        ftype = (y + seed) % 5
        prev = raw[y - 1:y] if y else np.zeros((1, raw.shape[1]), np.uint8)
        both = _filter_rows(np.concatenate([prev, raw[y:y + 1]]), ftype, bpp)
        out += both[len(both) // 2:]
    return out


def _png_any(samples, depth: int, color: int, *, interlace: int = 0,
             plte: bytes = None, trns: bytes = None, seed: int = 0) -> bytes:
    """A PNG of any colour type, bit depth and interlace, written by hand
    (Pillow writes few of them): ``samples`` [h, w, ch] are the stored
    samples (palette indices for colour type 3)."""
    samples = np.asarray(samples)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    if interlace:
        raw = b""
        for i, (y0, x0, dy, dx) in enumerate(ADAM7):
            part = samples[y0::dy, x0::dx]
            if part.size:
                raw += _filter_image(_pack_rows(part, depth), bpp, seed + i)
    else:
        raw = _filter_image(_pack_rows(samples, depth), bpp, seed)
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + (chunk(b"tRNS", trns) if trns is not None else b"")
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


#: (colour type, bit depth, tRNS kind): every layout of the PNG
#: specification; "key" is a tRNS colour key (gray, RGB), "alpha" a
#: palette's alpha table shorter than the palette
LAYOUTS = (
    [(0, d, None) for d in (1, 2, 4, 8, 16)]
    + [(3, d, t) for d in (1, 2, 4, 8) for t in (None, "alpha")]
    + [(c, d, None) for c in (2, 4, 6) for d in (8, 16)]
    + [(0, 8, "key"), (0, 16, "key"), (2, 8, "key"), (2, 16, "key")]
)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth,trns", LAYOUTS)
@pytest.mark.parametrize("shape", [(13, 11), (1, 1), (3, 2)])
def test_png_layouts_match_jax(color, depth, trns, interlace, shape):
    """Every colour type x bit depth x interlace, each row with its own
    filter type, decodes to the JAX package's pixels (Pillow here), exact:
    colour, and alpha where the JAX decode gives one. (1, 1) and (3, 2)
    leave Adam7 passes empty."""
    h, w = shape
    rng = np.random.default_rng(color * 100 + depth * 3 + interlace)
    ch = png._LAYOUT[color][0]
    top = 1 << depth
    samples = rng.integers(0, top, (h, w, ch))
    if depth == 16:  # keep some values below 256, where I;16 does not saturate
        samples[::2] %= 300
    plte = tr = None
    if color == 3:
        entries = rng.integers(0, 256, (max(1, top - 1), 3), dtype=np.uint8)
        plte = entries.tobytes()     # one index past the palette reads black
        if trns == "alpha":
            tr = rng.integers(0, 256, max(1, top // 2), dtype=np.uint8).tobytes()
    elif trns == "key":
        key = samples[0, 0]
        tr = b"".join(struct.pack(">H", int(v)) for v in key)
    data = _png_any(samples, depth, color, interlace=interlace, plte=plte, trns=tr,
                    seed=h + w)
    got, ref = codecs.decode(data), jcodecs.decode(data)
    _assert_same_decode(got, ref)
    assert got.mime == "image/png" and got.size == (w, h)


def test_png_16bit_gray_saturates_as_pillow():
    """The JAX package's PNG decode here is Pillow's, which saturates 16-bit
    gray at 255 (mode I;16 to RGB) where libpng's simplified API scales
    (ROADMAP Queue C 13): the port follows Pillow, pinned on the values
    Pillow maps to 0, 255, 255, 255 and 255."""
    samples = np.array([0, 255, 256, 4660, 65535]).reshape(1, 5, 1)
    data = _png_any(samples, 16, 0)
    rgb, alpha = png.decode(data)
    assert rgb[0, :, 0].tolist() == [0, 255, 255, 255, 255] and alpha is None
    np.testing.assert_array_equal(rgb, jcodecs.decode(data).rgb)


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif


def _assert_same_decode(got, ref):
    assert got.rgb.shape == ref.rgb.shape
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    if ref.alpha is None:
        assert got.alpha is None
    else:
        np.testing.assert_array_equal(got.alpha, ref.alpha)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_orientation_matches_jax(orientation, mode):
    """A 30x20 PNG with an eXIf chunk decodes upright, colour and alpha,
    as the JAX package's decode turns it."""
    rng = np.random.default_rng(orientation)
    arr = rng.integers(0, 256, (20, 30, len(mode)), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", exif=_exif(orientation))
    got, ref = codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue())
    if orientation >= 5:
        assert got.size == (20, 30)
    _assert_same_decode(got, ref)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_orientation_matches_jax(orientation, monkeypatch):
    """The APP1 orientation of a JPEG is applied after the decode (here the
    nvJPEG calls' stand-in), as the JAX package's decode applies it."""
    stand_in.install(monkeypatch)
    yy, xx = np.mgrid[0:24, 0:40]
    arr = np.stack([xx * 6, yy * 10, (xx + yy) * 4], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95, exif=_exif(orientation))
    got, ref = codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue())
    _assert_same_decode(got, ref)
    assert got.orig_size == (40, 24)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_webp_orientation_matches_jax(orientation, mode):
    rng = np.random.default_rng(orientation + 10)
    arr = rng.integers(0, 256, (20, 30, len(mode)), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "WEBP", lossless=True, exact=True,
                                    exif=_exif(orientation))
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


# ---------------------------------------------------------------------------
# JPEG around nvJPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(1920, 1080), (4000, 3000), (640, 480), (300, 250),
                                  (8000, 600), (33, 17)])
@pytest.mark.parametrize("hint", [None, (300, 250), (100, 100), (1000, 50), (0, 250),
                                  (30, 20), (2000, 2000)])
def test_jpeg_scale_selection_matches_jax(size, hint):
    w, h = size
    assert codecs.jpeg_batch_scale_num(MediaInfo("image/jpeg", w, h), hint) == \
        jcodecs.jpeg_batch_scale_num(JMediaInfo("image/jpeg", w, h), hint)


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (23.0 + 7 * c) + c) * np.cos(xx / 41.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["420", "444", "progressive"])
@pytest.mark.parametrize("hint,scale", [((60, 30), 1), ((120, 60), 2), ((200, 100), 4),
                                        ((400, 300), 8)])
def test_jpeg_decode_prescale_matches_jax(kind, hint, scale, monkeypatch):
    """A 960x540 JPEG decodes at the DCT scale its target hint picks, the
    size and pixels of the JAX package's decode (through the nvJPEG calls'
    stand-in, at that scale)."""
    stand_in.install(monkeypatch)
    buf = io.BytesIO()
    Image.fromarray(_photo(540, 960)).save(
        buf, "JPEG", quality=90, subsampling=0 if kind == "444" else 2,
        progressive=kind == "progressive")
    got = codecs.decode(buf.getvalue(), target_hint=hint)
    ref = jcodecs.decode(buf.getvalue(), target_hint=hint)
    assert stand_in.decode.calls == [{"scale_num": scale, "device": "cuda"}]
    assert got.size == (-(-960 * scale // 8), -(-540 * scale // 8))
    _assert_same_decode(got, ref)
    assert got.orig_size == ref.orig_size == (960, 540)


@pytest.mark.parametrize("quality", [90, 40])
@pytest.mark.parametrize("mozjpeg", [False, True])
@pytest.mark.parametrize("sampling", ["1x1", "2x2", "4:2:2"])
def test_jpeg_encode_options_reach_the_encoder(quality, mozjpeg, sampling, monkeypatch):
    """q_, moz_ and sf_ reach the nvJPEG encode call as the JAX package's
    encode reads them (moz_1: optimized Huffman tables and progressive
    scans; the trellis of the JAX package's native build waits); through
    the stand-in the bytes are the JAX package's."""
    stand_in.install(monkeypatch)
    img = _photo(50, 70, seed=3)
    got = codecs.encode(img, "jpg", quality=quality, mozjpeg=mozjpeg,
                        sampling_factor=sampling)
    ref = jcodecs.encode(img, "jpg", quality=quality, mozjpeg=mozjpeg,
                         sampling_factor=sampling)
    assert stand_in.encode.calls == [{
        "quality": quality, "optimize": mozjpeg, "progressive": mozjpeg,
        "sampling": jcodecs.parse_sampling_factor(sampling), "device": "cuda"}]
    assert got == ref


_SPELLINGS = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "4:1:0", "1x1", "2x2", "2x1",
              "1x2", "4x1", "4x2", "2x4", "1x4", "4X1", " 2x2 ", "", None, "1X1"]
_REFUSED = ["3x3", "0x1", "5x1", "axb", "4:2:1", "2x", "x2", "1x1x1", "-1x2", "4x4",
            "2:2:0", "1,1"]


@pytest.mark.parametrize("value", _SPELLINGS + _REFUSED)
def test_parse_sampling_factor_matches_jax(value):
    try:
        ref = jcodecs.parse_sampling_factor(value)
    except Exception as exc:  # the JAX package's InvalidArgumentException
        with pytest.raises(InvalidArgumentException) as got:
            codecs.parse_sampling_factor(value)
        assert str(got.value) == str(exc)
        assert value in _REFUSED
        return
    assert value in _SPELLINGS
    assert codecs.parse_sampling_factor(value) == ref


#: parsed factors nvJPEG has no chroma subsampling for
_UNMAPPED = ["1x3", "1x4", "2x3", "2x4", "3x1", "3x2"]


@pytest.mark.parametrize("value", _UNMAPPED)
def test_sampling_factors_nvjpeg_lacks_are_refused(value, monkeypatch):
    """Factors that parse but that nvJPEG cannot subsample to raise
    UnsupportedMediaException before any encode call, where the JAX
    package encodes them (ROADMAP Queue A 2)."""
    stand_in.install(monkeypatch)
    img = _photo(40, 48, seed=5)
    assert jcodecs.parse_sampling_factor(value) == codecs.parse_sampling_factor(value)
    assert Image.open(io.BytesIO(jcodecs.encode(img, "jpg", sampling_factor=value))).size \
        == (48, 40)
    with pytest.raises(UnsupportedMediaException, match=f"sampling factor {value}"):
        codecs.encode(img, "jpg", sampling_factor=value)
    assert stand_in.encode.calls == []


# ---------------------------------------------------------------------------
# WebP (VP8L)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 37), (29, 1), (37, 53), (250, 300)])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_webp_lossless_round_trips_exactly(shape, with_alpha):
    h, w = shape
    img = _photo(h, w, seed=h * w)
    alpha = np.random.default_rng(h).integers(0, 256, shape).astype(np.uint8) \
        if with_alpha else None
    data = codecs.encode(img, "webp", alpha, webp_lossless=True)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(pil[..., :3], img)
    back = codecs.decode(data)
    np.testing.assert_array_equal(back.rgb, img)
    if with_alpha:
        np.testing.assert_array_equal(pil[..., 3], alpha)
        np.testing.assert_array_equal(back.alpha, alpha)
    else:
        assert back.alpha is None and (pil[..., 3] == 255).all()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_webp_lossy_request_is_refused():
    """webpl_0 (the default) answers lossy WebP, as the JAX package does
    (the name is the test's from before the port had a VP8 encoder): a VP8
    file at the asked quality, valid for the JAX package's decoder, above
    30 dB PSNR on this source and within 0.75 dB of the JAX package's q90
    file at no more than 1.3x its bytes."""
    img = _photo(250, 300, seed=7)
    for data in (codecs.encode(img, "webp", quality=90, webp_lossless=False),
                 codecs.encode(img, "webp")):
        assert data[12:16] == b"VP8 "
        back = jcodecs.decode(data).rgb
        np.testing.assert_array_equal(codecs.decode(data).rgb, back)
        assert _psnr(back, img) > 30.0
    ref = jcodecs.encode(img, "webp", quality=90, webp_lossless=False)
    ref_back = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    assert _psnr(ref_back, img) > 30.0
    assert _psnr(back, img) >= _psnr(ref_back, img) - 0.75
    assert len(data) <= 1.3 * len(ref)


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_webp_decode_of_libwebp_files_matches_jax(method, mode):
    """Lossless WebPs written by libwebp (Pillow) at three effort levels
    (transforms, colour cache, backward references, meta prefix codes)
    decode to the JAX package's pixels."""
    rng = np.random.default_rng(method)
    img = _photo(61, 87, seed=method)
    if mode == "RGBA":
        img = np.dstack([img, rng.integers(0, 256, (61, 87)).astype(np.uint8)])
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "WEBP", lossless=True, method=method)
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


def test_webp_decode_of_a_palette_file_matches_jax():
    """A few colours make libwebp write the colour-indexing transform with
    pixels bundled into bytes."""
    rng = np.random.default_rng(4)
    img = (rng.integers(0, 3, (40, 41))[..., None] * np.array([[[80, 40, 20]]])).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True)
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


def test_lossy_webp_source_is_refused():
    """A lossy (VP8) WebP source decodes to the JAX package's pixels (the
    name is the test's from before the port had a VP8 decoder)."""
    buf = io.BytesIO()
    Image.fromarray(_photo(20, 30)).save(buf, "WEBP", quality=80)
    assert jcodecs.decode(buf.getvalue()).size == (30, 20)
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


def test_jpeg_fixtures_are_the_jax_package_s():
    """tests/data/jpeg (what the card's nvJPEG tests compare with) is what
    tools/make_jpeg_fixtures.py writes from the JAX package: the same
    JPEG bytes, the same decoded pixels, the same reference numbers."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(root, "tools", "make_jpeg_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    built = tool.build()
    names = sorted(os.listdir(tool.DEFAULT_OUT))
    assert names == sorted(built)
    for name, data in built.items():
        with open(os.path.join(tool.DEFAULT_OUT, name), "rb") as fh:
            stored = fh.read()
        if name.endswith(".png"):
            np.testing.assert_array_equal(png.decode(stored)[0], png.decode(data)[0])
        else:
            assert stored == data, name


def _libjpeg_ycc(rgb, hf, vf):
    """jccolor.c rgb_ycc_convert and jcsample.c's downsamplers, pixel by
    pixel as libjpeg writes them (the right and bottom edges replicated)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    h, w, _ = rgb.shape
    y = np.zeros((h, w), np.int64)
    cb = np.zeros((h, w), np.int64)
    cr = np.zeros((h, w), np.int64)
    for i in range(h):
        for j in range(w):
            r, g, b = (int(v) for v in rgb[i, j])
            y[i, j] = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + 32768) >> 16
            cb[i, j] = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
                        + (128 << 16) + 32767) >> 16
            cr[i, j] = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
                        + (128 << 16) + 32767) >> 16
    if (hf, vf) == (1, 1):
        return y, cb, cr
    ch, cw = -(-h // vf), -(-w // hf)
    out = []
    for plane in (cb, cr):
        down = np.zeros((ch, cw), np.int64)
        for oi in range(ch):
            bias = {(2, 1): 0, (2, 2): 1}.get((hf, vf), hf * vf // 2)
            for oj in range(cw):
                total = sum(int(plane[min(oi * vf + a, h - 1), min(oj * hf + c, w - 1)])
                            for a in range(vf) for c in range(hf))
                if (hf, vf) == (2, 1):
                    down[oi, oj] = (total + bias) >> 1
                    bias ^= 1
                elif (hf, vf) == (2, 2):
                    down[oi, oj] = (total + bias) >> 2
                    bias ^= 3
                else:
                    down[oi, oj] = (total + bias) // (hf * vf)
        out.append(down)
    return (y, *out)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "4:1:0"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (16, 16), (9, 6)])
def test_jpeg_encode_planes_are_libjpeg_s(sampling, shape):
    """The YCbCr planes the port hands nvJPEG are libjpeg's (its colour
    conversion and chroma downsampling, written out pixel by pixel here)."""
    from flyimg_tpu_torch.codecs import native_codec

    hf, vf = codecs.parse_sampling_factor(sampling)
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    rgb[0, 0] = (255, 0, 255)
    got = native_codec.ycbcr_planes(torch.from_numpy(rgb), (hf, vf))
    for g, want in zip(got, _libjpeg_ycc(rgb, hf, vf)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), want)


def _fixture(name):
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg", name)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name,transform", [("q90_cmyk", 0), ("q90_ycck", 2)])
def test_cmyk_and_ycck_conversion_is_the_jax_decode_s(name, transform):
    """nvJPEG decodes a four-component JPEG's planes as coded; the port's
    conversion of those planes (libjpeg's YCCK -> CMYK, Pillow's inverted
    Adobe polarity and CMYK -> RGB) gives the JAX package's decode exactly.
    libjpeg's planes of both fixtures are the CMYK reading's (the YCCK file
    differs in its APP14 transform byte only), 255 - Pillow's CMYK samples.
    The card holds nvJPEG's planes (chip_smoke.py phase 10)."""
    data = _fixture(name + ".jpg")
    assert native_codec.adobe_transform(data) == transform
    coded = 255 - np.asarray(Image.open(io.BytesIO(_fixture("q90_cmyk.jpg"))))
    got = native_codec.cmyk_rgb(torch.from_numpy(coded.transpose(2, 0, 1).copy()),
                                ycck=transform == 2)
    want, _ = png.decode(_fixture(name + ".s8.png"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, jcodecs.decode(data).rgb)


def test_adobe_transform_absent_outside_app14():
    assert native_codec.adobe_transform(_fixture("q90_gray.jpg")) is None
    assert native_codec.adobe_transform(_fixture("q90_420.jpg")) is None
