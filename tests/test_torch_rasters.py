"""The port's animated WebP, BMP, ICO and TIFF sources
(``flyimg_tpu_torch/codecs/webp_anim.py``, ``bmp.py``, ``ico.py``,
``tiff.py``), held against the JAX package's Pillow decode on the CPU.

Every layout decodes exactly as ``pil_codec.decode`` (and, for animations,
the handler's ``_decode_all_frames``) decodes it: Pillow-written files and
hand-built ones (``format_writers``) for what Pillow's writers never
produce. The committed fixtures equal their PNGs. The handler answers a BMP,
an ICO and a TIFF source as the JAX handler does. Inputs come from numpy
with fixed seeds.
"""

import io
import json
import os
import zlib

import format_writers as fb
import numpy as np
import pytest
import torch_jpeg_stand_in as stand_in
from PIL import Image

from flyimg_tpu.codecs import pil_codec
from flyimg_tpu.service.handler import _decode_all_frames
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.exceptions import UnsupportedMediaException

DATA = os.path.join(os.path.dirname(__file__), "data")
HANDLER_PSNR_DB = 30.0


def photo(h, w, seed, shift=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // max(w - 1, 1) + shift) % 256, y * 255 // max(h - 1, 1),
                    ((x + y) * 127 // max(w + h - 2, 1) + 2 * shift) % 256], -1)
    return np.clip(img + rng.integers(-12, 13, size=img.shape), 0, 255).astype(np.uint8)


def assert_same_still(data, frame=0):
    ref = pil_codec.decode(data, frame=frame)
    got = codecs.decode(data, frame=frame, device="cpu")
    assert got.n_frames == ref.n_frames
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert (got.alpha is None) == (ref.alpha is None)
    if ref.alpha is not None:
        np.testing.assert_array_equal(got.alpha, ref.alpha)


def assert_same_animation(data):
    want = _decode_all_frames(data)
    got = codecs.decode_all(data)
    assert got.durations == want.durations and got.loop == want.loop
    assert len(got.frames) == len(want.frames)
    assert (got.alphas is None) == (want.alphas is None)
    for i, frame in enumerate(want.frames):
        np.testing.assert_array_equal(got.frames[i], frame, err_msg=f"frame {i}")
        if want.alphas is not None:
            np.testing.assert_array_equal(got.alphas[i], want.alphas[i], err_msg=f"alpha {i}")
    for f in range(len(want.frames) + 1):
        assert_same_still(data, f)


# ------------------------------------------------------------ animated WebP


def _webp_frames(n, alpha, seed=0):
    y, x = np.mgrid[0:40, 0:56]
    out = []
    for k in range(n):
        f = photo(40, 56, seed + k, 20 * k)
        if alpha:
            a = np.clip(((x + k * 9) % 56) * 5, 0, 255).astype(np.uint8)
            a[(y // 8) % 2 == 0] = 255
            a[:, :5] = 0
            out.append(Image.fromarray(np.dstack([f, a])))
        else:
            out.append(Image.fromarray(f))
    return out


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("kw", [{}, {"minimize_size": True}, {"kmax": 1},
                                {"allow_mixed": True}])
def test_pillow_webp_animations_decode_as_the_jax_package(lossless, alpha, kw):
    frames = _webp_frames(4, alpha, seed=3)
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=[40, 50, 60, 70], loop=3, lossless=lossless, quality=70, **kw)
    assert_same_animation(buf.getvalue())


def _rgba(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    a[: h // 3] = 255
    a[-2:] = 0
    return np.dstack([photo(h, w, seed), a])


@pytest.mark.parametrize("blend", [True, False])
@pytest.mark.parametrize("dispose", [False, True])
@pytest.mark.parametrize("file_alpha", [True, False])
def test_hand_built_webp_animations_decode_as_the_jax_package(blend, dispose, file_alpha):
    """Offsets, blending or not, disposing to the background or not, and
    VP8L, VP8+ALPH and VP8 frames mixed, on a canvas with and without the
    file's alpha flag."""
    frames = [
        dict(payload=fb.webp_frame(_rgba(32, 48, 1), lossless=True), size=(48, 32)),
        dict(payload=fb.webp_frame(_rgba(14, 20, 2), lossless=False), size=(20, 14),
             offset=(10, 8), blend=blend, dispose=dispose),
        dict(payload=fb.webp_frame(_rgba(20, 22, 3), lossless=True), size=(22, 20),
             offset=(16, 12), blend=blend, dispose=not dispose),
        dict(payload=fb.webp_frame(photo(12, 14, 4), lossless=False), size=(14, 12),
             offset=(32, 18), blend=blend, dispose=dispose),
        dict(payload=fb.webp_frame(_rgba(32, 48, 5), lossless=False), size=(48, 32),
             blend=not blend, dispose=dispose),
        dict(payload=fb.webp_frame(_rgba(12, 20, 6), lossless=True), size=(20, 12),
             offset=(2, 20), blend=blend),
    ]
    for k, f in enumerate(frames):
        f["duration"] = 30 + 10 * k
    assert_same_animation(fb.webp_animation((48, 32), frames, alpha=file_alpha, loop=1))


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(os.path.join(DATA, "webp_anim")) if f.endswith(".webp")))
def test_webp_animation_fixtures_equal_their_pngs(name):
    folder = os.path.join(DATA, "webp_anim")
    with open(os.path.join(folder, name + ".webp"), "rb") as fh:
        data = fh.read()
    ref = json.load(open(os.path.join(folder, "reference.json")))[name]
    anim = codecs.decode_all(data)
    assert len(anim.frames) == ref["frames"] and anim.durations == ref["durations"]
    assert anim.loop == ref["loop"]
    for i, frame in enumerate(anim.frames):
        with open(os.path.join(folder, f"{name}.f{i}.png"), "rb") as fh:
            rgb, alpha = png.decode(fh.read())
        np.testing.assert_array_equal(frame, rgb)
        if anim.alphas is not None:
            np.testing.assert_array_equal(anim.alphas[i], alpha)
    assert_same_animation(data)


# ------------------------------------------------------------------ BMP

_RNG = np.random.default_rng(20)
_PAL = _RNG.integers(0, 256, size=(256, 3)).astype(np.uint8)
H, W = 23, 37


def _indices(bits, seed):
    return np.random.default_rng(seed).integers(0, 1 << bits, size=(H, W)).astype(np.uint8)


def _bmp_case(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    rgba = np.dstack([photo(H, W, 5), rng.integers(0, 256, size=(H, W)).astype(np.uint8)])
    words = rng.integers(0, 65536, size=(H, W)).astype(np.uint16)
    runs = np.repeat(rng.integers(0, 16, size=(H, W // 4 + 1)), 4, axis=1)[:, :W]
    runs = runs.astype(np.uint8)
    runs[3, 5:20] = rng.integers(0, 16, 15)
    kind, _, rest = case.partition("-")
    if kind in ("pal1", "pal4", "pal8"):
        bits = int(kind[3:])
        header, top = (int(rest[1:]), False) if rest.startswith("h") else (40, rest == "topdown")
        return fb.bmp(_indices(bits, 1), bits=bits, palette=_PAL[: 1 << bits], header=header,
                      top_down=top)
    if kind == "rle8":
        return fb.bmp(runs, bits=8, palette=_PAL, compression=1, top_down=rest == "topdown")
    if kind == "rle4":
        return fb.bmp(runs, bits=4, palette=_PAL[:16], compression=2,
                      top_down=rest == "topdown")
    if kind == "gray8":
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        return fb.bmp(_indices(8, 2), bits=8, palette=ramp)
    if kind == "bw1":
        return fb.bmp(_indices(1, 3), bits=1, palette=np.array([[0] * 3, [255] * 3]))
    if kind == "555":
        return fb.bmp(words, bits=16)
    if kind == "565":
        return fb.bmp(words, bits=16, compression=3, masks=(0xF800, 0x7E0, 0x1F),
                      header=int(rest or 40))
    if kind == "555bf":
        return fb.bmp(words, bits=16, compression=3, masks=(0x7C00, 0x3E0, 0x1F), header=56)
    if kind == "24":
        return fb.bmp(rgba[..., :3], bits=24, top_down=rest == "topdown")
    if kind == "32raw":
        return fb.bmp(rgba, bits=32, layout="BGRA")
    masks = {"32bgra": ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), "BGRA"),
             "32bgrx": ((0xFF0000, 0xFF00, 0xFF, 0), "BGRX"),
             "32rgba": ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), "RGBA"),
             "32abgr": ((0xFF000000, 0xFF0000, 0xFF00, 0xFF), "ABGR")}[kind]
    return fb.bmp(rgba, bits=32, compression=3, masks=masks[0], layout=masks[1],
                  header=int(rest))


BMP_CASES = (
    [f"pal{b}-h{h}" for b in (1, 4, 8) for h in (12, 40, 108, 124)]
    + [f"pal{b}-topdown" for b in (1, 4, 8)]
    + ["rle8", "rle8-topdown", "rle4", "rle4-topdown", "gray8", "bw1", "555", "565",
       "565-108", "555bf", "24", "24-topdown", "32raw"]
    + [f"{k}-{h}" for k in ("32bgra", "32bgrx", "32rgba", "32abgr") for h in (56, 108, 124)]
)


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_layouts_decode_as_the_jax_package(case):
    data = _bmp_case(case)
    assert_same_still(data)
    assert codecs.decode(data, device="cpu").mime == "image/bmp"


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillow_bmps_decode_as_the_jax_package(mode):
    buf = io.BytesIO()
    Image.fromarray(np.dstack([photo(H, W, 6), np.full((H, W), 128, np.uint8)])) \
        .convert(mode).save(buf, "BMP")
    assert_same_still(buf.getvalue())


@pytest.mark.parametrize("compression,name", [(4, "JPEG"), (5, "PNG")])
def test_bmp_compressions_not_ported_are_refused_by_name(compression, name):
    data = bytearray(fb.bmp(_indices(8, 1), bits=8, palette=_PAL))
    data[30] = compression
    with pytest.raises(UnsupportedMediaException, match=f"BMP compression {name}"):
        codecs.decode(bytes(data), device="cpu")


# ------------------------------------------------------------------ ICO


def _ico_case(case):
    rng = np.random.default_rng(9)
    rgba = np.dstack([photo(16, 16, 7), rng.integers(0, 256, size=(16, 16)).astype(np.uint8)])
    idx4 = rng.integers(0, 16, size=(16, 16)).astype(np.uint8)
    idx8 = rng.integers(0, 256, size=(16, 16)).astype(np.uint8)
    mask = (rng.random((16, 16)) < 0.3).astype(np.uint8)
    d4 = fb.ico_dib(idx4, bits=4, palette=_PAL[:16], mask=mask)
    d8 = fb.ico_dib(idx8, bits=8, palette=_PAL, mask=mask)
    d32 = fb.ico_dib(rgba[..., :3], bits=32, alpha=rgba[..., 3])
    d24 = fb.ico_dib(np.ascontiguousarray(np.tile(rgba[..., :3], (2, 2, 1))), bits=24,
                     mask=np.tile(mask, (2, 2)))
    buf = io.BytesIO()
    Image.fromarray(np.dstack([photo(20, 20, 8), np.full((20, 20), 90, np.uint8)])) \
        .save(buf, "PNG")
    entries = {
        "dib4": ([d4], [(16, 16)], [4]),
        "dib8": ([d8], [(16, 16)], [8]),
        "dib24": ([d24], [(32, 32)], [24]),
        "dib32": ([d32], [(16, 16)], [32]),
        "largest": ([d4, d24, d32], [(16, 16), (32, 32), (16, 16)], [4, 24, 32]),
        "least_depth": ([d32, d4, d8], [(16, 16)] * 3, [32, 4, 8]),
        "png_entry": ([d4, buf.getvalue()], [(16, 16), (20, 20)], [4, 32]),
    }[case]
    return fb.ico(*entries)


@pytest.mark.parametrize("case", ["dib4", "dib8", "dib24", "dib32", "largest", "least_depth",
                                  "png_entry"])
def test_ico_layouts_decode_as_the_jax_package(case):
    assert_same_still(_ico_case(case))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "P", "L", "LA"])
@pytest.mark.parametrize("fmt", ["png", "bmp"])
def test_pillow_icos_decode_as_the_jax_package(mode, fmt):
    img = Image.fromarray(np.dstack([photo(32, 32, 9), np.tile(
        np.arange(0, 256, 8, dtype=np.uint8), (32, 1))])).convert(mode)
    buf = io.BytesIO()
    if mode == "LA" and fmt == "bmp":
        img = img.convert("RGBA")
    img.save(buf, "ICO", sizes=[(16, 16), (32, 32)], bitmap_format=fmt)
    assert_same_still(buf.getvalue())


# ------------------------------------------------------------------ TIFF


def _tiff_page(case, seed=11):
    rng = np.random.default_rng(seed)
    rgba = np.dstack([photo(H, W, seed), rng.integers(0, 256, size=(H, W)).astype(np.uint8)])
    a = rgba[..., 3:]
    prem = np.concatenate([(rgba[..., :3].astype(int) * a // 255).astype(np.uint8), a], -1)
    g8 = rgba[..., :1]
    cmap = [int(v) * 257 for c in range(3) for v in _PAL[:, c]]
    cmap4 = [int(v) * 257 for c in range(3) for v in _PAL[:16, c]]
    return {
        "gray8": dict(samples=g8, bits=8, photometric=1),
        "gray8_white_is_zero": dict(samples=g8, bits=8, photometric=0),
        "gray16": dict(samples=rng.integers(0, 1024, size=(H, W, 1)).astype(np.uint16),
                       bits=16, photometric=1),
        "gray_alpha": dict(samples=np.concatenate([g8, a], -1), bits=8, photometric=1,
                           extra=[2]),
        "rgb": dict(samples=rgba[..., :3], bits=8, photometric=2),
        "rgbx": dict(samples=rgba, bits=8, photometric=2, extra=[0]),
        "rgba_unassociated": dict(samples=rgba, bits=8, photometric=2, extra=[2]),
        "rgba_associated": dict(samples=prem, bits=8, photometric=2, extra=[1]),
        "rgb16": dict(samples=rng.integers(0, 65536, size=(H, W, 3)).astype(np.uint16),
                      bits=16, photometric=2),
        "rgba16": dict(samples=rng.integers(0, 65536, size=(H, W, 4)).astype(np.uint16),
                       bits=16, photometric=2, extra=[2]),
        "palette8": dict(samples=rng.integers(0, 256, size=(H, W, 1)).astype(np.uint8),
                         bits=8, photometric=3, colormap=cmap),
        "palette4": dict(samples=rng.integers(0, 16, size=(H, W, 1)).astype(np.uint8),
                         bits=4, photometric=3, colormap=cmap4),
        "bilevel": dict(samples=(rng.random((H, W, 1)) < 0.5).astype(np.uint8), bits=1,
                        photometric=1),
        "bilevel_white_is_zero": dict(samples=(rng.random((H, W, 1)) < 0.5).astype(np.uint8),
                                      bits=1, photometric=0),
    }[case]


TIFF_LAYOUTS = ["gray8", "gray8_white_is_zero", "gray16", "gray_alpha", "rgb", "rgbx",
                "rgba_unassociated", "rgba_associated", "rgb16", "rgba16", "palette8",
                "palette4", "bilevel", "bilevel_white_is_zero"]
TIFF_CODINGS = ["none", "packbits", "lzw", "deflate", "lzw_pred2", "deflate_pred2"]
#: libtiff takes horizontal differencing of 8- and 16-bit samples only
TIFF_STRIP_CASES = [(layout, coding) for layout in TIFF_LAYOUTS for coding in TIFF_CODINGS
                    if not (coding.endswith("pred2")
                            and layout in ("palette4", "bilevel", "bilevel_white_is_zero"))]


@pytest.mark.parametrize("layout,coding", TIFF_STRIP_CASES)
@pytest.mark.parametrize("big_endian", [False, True])
def test_tiff_strips_decode_as_the_jax_package(layout, coding, big_endian):
    page = _tiff_page(layout)
    comp = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8}[coding.split("_")[0]]
    pred = 2 if coding.endswith("pred2") else 1
    page = dict(page, compression=comp, predictor=pred, rows_per_strip=5)
    data = fb.tiff([page], big_endian=big_endian)
    assert_same_still(data)
    assert codecs.decode(data, device="cpu").mime == "image/tiff"


@pytest.mark.parametrize("layout", ["gray8", "gray16", "rgb", "rgba_associated", "rgba16",
                                    "palette8"])
@pytest.mark.parametrize("coding", ["none", "deflate_pred2", "lzw"])
@pytest.mark.parametrize("big_endian", [False, True])
def test_tiff_tiles_decode_as_the_jax_package(layout, coding, big_endian):
    comp = {"none": 1, "lzw": 5, "deflate": 8}[coding.split("_")[0]]
    page = dict(_tiff_page(layout), compression=comp,
                predictor=2 if coding.endswith("pred2") else 1, tile=(16, 16))
    assert_same_still(fb.tiff([page], big_endian=big_endian))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_turns_the_page_upright(orientation):
    page = dict(_tiff_page("rgba_unassociated"), orientation=orientation)
    assert_same_still(fb.tiff([page]))


@pytest.mark.parametrize("frame", [0, 1, 2, 7])
def test_tiff_pages_seek_as_gif_frames(frame):
    pages = [dict(_tiff_page("rgb", 1), compression=5),
             dict(_tiff_page("gray8", 2), compression=8),
             dict(_tiff_page("rgba_unassociated", 3), compression=32773)]
    assert_same_still(fb.tiff(pages), frame)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw", "tiff_adobe_deflate"])
def test_pillow_tiffs_decode_as_the_jax_package(mode, compression):
    rgba = np.dstack([photo(H, W, 12), np.tile(np.arange(W, dtype=np.uint8) * 7, (H, 1))])
    img = Image.fromarray(rgba)
    if mode == "I;16":
        img = Image.fromarray((np.arange(H * W).reshape(H, W) * 97 % 65536).astype(np.uint16))
    elif mode == "P":
        img = img.convert("RGB").convert("P", palette=Image.Palette.ADAPTIVE, colors=200)
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    assert_same_still(buf.getvalue())


@pytest.mark.parametrize("compression,mode,name", [
    ("jpeg", "RGB", "JPEG"), ("group4", "1", "CCITT Group 4"), ("group3", "1", "CCITT Group 3"),
])
def test_tiff_compressions_not_ported_are_refused_by_name(compression, mode, name):
    """TIFF JPEG and CCITT Group 3 and 4, once refused by name, decode as
    the JAX package's Pillow decodes them (max difference 0)."""
    img = Image.fromarray(photo(H, W, 13)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    assert pil_codec.decode(buf.getvalue()).rgb.shape == (H, W, 3)
    assert_same_still(buf.getvalue())


def _pillow_tiff(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


_RGB = photo(H, W, 25)
#: layouts the port refuses by name that Pillow writes and decodes here
#: (ROADMAP Queue C 18); Pillow's own planar LZW file and a raw YCbCr page
#: it does not decode (it raises), so they are no departure
_REFUSED_LAYOUTS = {
    "planar_separate": lambda: _pillow_tiff(Image.fromarray(_RGB), tiffinfo={284: 2}),
    "fill_order_2": lambda: _pillow_tiff(Image.fromarray(_RGB), tiffinfo={266: 2}),
    "fill_order_2_lzw": lambda: _pillow_tiff(Image.fromarray(_RGB), compression="tiff_lzw",
                                             tiffinfo={266: 2}),
    "float_predictor_3": lambda: _pillow_tiff(
        Image.fromarray(_RGB[..., 0].astype(np.float32)), compression="tiff_adobe_deflate",
        tiffinfo={317: 3}),
    "float": lambda: _pillow_tiff(Image.fromarray(_RGB[..., 0].astype(np.float32))),
    "signed_32": lambda: _pillow_tiff(Image.fromarray(_RGB[..., 0].astype(np.int32) - 100)),
    "cmyk": lambda: _pillow_tiff(Image.fromarray(_RGB).convert("CMYK")),
    "cmyk_lzw": lambda: _pillow_tiff(Image.fromarray(_RGB).convert("CMYK"),
                                     compression="tiff_lzw"),
    "lab": lambda: _pillow_tiff(Image.fromarray(_RGB).convert("LAB")),
    "bigtiff": lambda: _pillow_tiff(Image.fromarray(_RGB), big_tiff=True),
}


@pytest.mark.parametrize("layout", sorted(_REFUSED_LAYOUTS))
def test_tiff_layouts_still_refused_depart_from_pillow(layout):
    """A departure kept on purpose (ROADMAP Queue C 18): Pillow writes and
    decodes these pages; the port answers 415 naming the layout."""
    data = _REFUSED_LAYOUTS[layout]()
    assert pil_codec.decode(data).rgb.shape == (H, W, 3)
    with pytest.raises(UnsupportedMediaException, match="not ported"):
        codecs.decode(data, device="cpu")


@pytest.mark.parametrize("layout", ["planar_separate_lzw", "ycbcr_uncompressed"])
def test_tiff_layouts_pillow_fails_on_fail_in_the_port_too(layout):
    """Pillow's planar LZW file (a strip of 0 bytes) and an uncompressed
    YCbCr page: Pillow raises on its own files, and so does the port."""
    img = Image.fromarray(_RGB)
    data = (_pillow_tiff(img, compression="tiff_lzw", tiffinfo={284: 2})
            if layout == "planar_separate_lzw" else _pillow_tiff(img.convert("YCbCr")))
    with pytest.raises(Exception):
        pil_codec.decode(data)
    with pytest.raises(UnsupportedMediaException):
        codecs.decode(data, device="cpu")


# ------------------------------------------------------------------ TIFF JPEG


@pytest.mark.parametrize("quality", [60, 95])
@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr", "CMYK", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (203, 157), (2048, 90)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_jpeg_tiffs_decode_as_the_jax_package(size, mode, quality):
    """The JPEG-compressed TIFFs Pillow writes (libtiff: the tables in
    JPEGTables, a JPEG stream a strip, strips of a multiple of 8 rows and a
    last one of the rest; 2048 wide takes 6 strips): gray, RGB, YCbCr,
    CMYK (converted as Pillow converts it) and RGBA (its fourth sample the
    alpha), every strip in one batch of the port's JPEG decoder."""
    w, h = size
    rgb = photo(h, w, 21)
    if mode == "RGBA":
        img = Image.fromarray(np.dstack([rgb, rgb[..., 1]]))
    else:
        img = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression="jpeg", quality=quality)
    assert_same_still(buf.getvalue())


def _jpeg_split(data: bytes):
    """A JPEG as libtiff stores it: (JPEGTables: SOI, its DQT and DHT
    segments, EOI; the abbreviated stream without them)."""
    tables, stream, i = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while data[i + 1] != 0xDA:
        seg = data[i:i + 2 + int.from_bytes(data[i + 2:i + 4], "big")]
        (tables if data[i + 1] in (0xC4, 0xDB) else stream).append(seg)
        i += len(seg)
    return b"".join(tables + [b"\xff\xd9"]), b"".join(stream) + data[i:]


@pytest.fixture(scope="module")
def jpeg_enc(tmp_path_factory):
    import jpeg_test_files as jt
    from jax_fastcodec import tool

    reason = tool.missing()
    if reason:
        pytest.skip(reason)
    return jt.encoder(str(tmp_path_factory.mktemp("tiff_jpeg_encoder")))


@pytest.mark.parametrize("tables", [True, False], ids=["jpegtables", "whole_streams"])
@pytest.mark.parametrize("layout", ["ycbcr420_rows8", "ycbcr422_rows24", "ycbcr420_tiles",
                                    "rgb_ids_012", "miniswhite", "progressive_restarts"])
def test_hand_built_jpeg_tiffs_decode_as_the_jax_package(jpeg_enc, layout, tables):
    """Strips and tiles of streams libtiff would not write itself:
    photometric YCbCr with tag 530 and 4:2:0 or 4:2:2 streams in strips of
    8 and 24 rows (not a multiple of the MCU height) or in tiles, an RGB
    page whose streams carry no colour marker and YCbCr's component ids
    (libtiff decodes it unconverted), min-is-white gray, progressive streams
    with restart markers; with the tables in tag 347 or in every stream."""
    w, h = 77, 53
    rgb = photo(h, w, 22)
    photometric, spp, sampling = 6, 3, (2, 2)
    extra = []
    if layout == "ycbcr422_rows24":
        sampling = (2, 1)
    if layout.startswith("ycbcr"):
        extra.append((530, 3, list(sampling)))
    if layout == "rgb_ids_012":
        photometric, sampling = 2, (1, 1)
    if layout == "miniswhite":
        photometric, spp = 0, 1
    per = {"ycbcr420_rows8": 8, "ycbcr422_rows24": 24}.get(layout, 16)
    progressive = layout == "progressive_restarts"

    def stream(block):
        pixels = block[..., 0] if spp == 1 else block
        data = jpeg_enc(pixels, 85, sampling, progressive, 2 if progressive else 0)
        if layout == "rgb_ids_012":
            # the encoder's YCbCr stream, read raw by libtiff: ids 1, 2, 3
            # and a JFIF marker say YCbCr, the photometric tag says RGB
            assert b"JFIF" in data
        return data

    page = dict(samples=np.zeros((h, w, spp), np.uint8), bits=8, photometric=photometric,
                compression=7)
    if layout == "ycbcr420_tiles":
        boxes = [(y, x) for y in range(0, h, 32) for x in range(0, w, 32)]
        streams = []
        for y, x in boxes:
            block = np.zeros((32, 32, 3), np.uint8)
            part = rgb[y:y + 32, x:x + 32]
            block[:part.shape[0], :part.shape[1]] = part
            streams.append(stream(block))
        page["tile"] = (32, 32)
    else:
        streams = [stream(rgb[y:y + per]) for y in range(0, h, per)]
        page["rows_per_strip"] = per
    if tables:
        split = [_jpeg_split(d) for d in streams]
        extra.append((347, 7, list(split[0][0])))
        streams = [b for _, b in split]
    page["blobs"] = streams
    page["tags"] = extra
    assert_same_still(fb.tiff([page]))


def test_jpeg_tiff_strips_share_one_launch_of_each_kernel(monkeypatch):
    """A page's strips (11 here) are one batch: one K18 and one K19 launch."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    calls = []
    real = jpeg_dec.decode_batch

    def spy(items, *args, **kwargs):
        calls.append(len(items))
        return real(items, *args, **kwargs)

    monkeypatch.setattr(jpeg_dec, "decode_batch", spy)
    buf = io.BytesIO()
    Image.fromarray(photo(300, 2048, 23)).save(buf, "TIFF", compression="jpeg")
    got = codecs.decode(buf.getvalue(), device="cpu")
    assert got.rgb.shape == (300, 2048, 3) and calls == [19]


@pytest.mark.parametrize("name", ["strips.tif", "g4_page.tif"])
def test_ingest_tiff_fixtures_equal_their_references(name):
    """chip_smoke.py phase 16's committed TIFFs (1024x768 in JPEG strips, a
    2550x3300 Group 4 page) decode to the SHA-256 reference.json holds:
    the JAX package's Pillow decode (tools/make_ingest_fixtures.py)."""
    import hashlib

    folder = os.path.join(DATA, "ingest")
    with open(os.path.join(folder, "reference.json")) as fh:
        want = json.load(fh)[name]
    with open(os.path.join(folder, name), "rb") as fh:
        rgb = codecs.decode(fh.read(), device="cpu").rgb
    assert list(rgb.shape) == want["shape"]
    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest() == want["sha256"]


# ------------------------------------------------------------------ TIFF CCITT


def _bilevel(h, w, seed):
    """A seeded page of text-like strokes, noise and long runs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    ink = (np.sin(x / (7 + seed % 5)) + np.cos(y / 9.0)) > 0.3
    ink ^= rng.random((h, w)) < 0.02
    ink[h // 3:h // 2] = rng.random(w) < 0.5
    ink[:, w // 4] = True
    ink[-1] = False
    return np.where(ink, 0, 255).astype(np.uint8)


CCITT_VARIANTS = {
    "g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}), "g3_2d_fill": ("group3", {292: 5}),
    "g3_fill": ("group3", {292: 4}), "g3_fillorder2": ("group3", {266: 2, 292: 1}),
    "g4": ("group4", {}), "g4_fillorder2": ("group4", {266: 2}),
    "g4_minisblack": ("group4", {262: 1}), "g3_minisblack": ("group3", {262: 1}),
    "rle": ("tiff_ccitt", {}), "rle_word": ("tiff_raw_16", {}),
    "g4_strips7": ("group4", {278: 7}),
    "g3_2d_strips5": ("group3", {292: 1, 278: 5}), "rle_strips3": ("tiff_ccitt", {278: 3}),
}


def _ccitt(variant, h, w, seed=24):
    compression, info = CCITT_VARIANTS[variant]
    buf = io.BytesIO()
    Image.fromarray(_bilevel(h, w, seed)).convert("1").save(
        buf, "TIFF", compression=compression, tiffinfo=info)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(1, 1), (7, 3), (64, 40), (203, 157), (1728, 30),
                                  (2600, 12), (5000, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", sorted(CCITT_VARIANTS))
def test_pillow_ccitt_tiffs_decode_as_the_jax_package(variant, size):
    """CCITT modified Huffman (2, and 32771 with its rows on 16-bit words),
    Group 3 1-D and 2-D with and without EOL fill (T4Options 0, 1, 4, 5)
    and Group 4, FillOrder 2, min-is-white and min-is-black, one strip and
    several, widths past every make-up code (5000): the page equals
    Pillow's decode, white 255 and black 0 in RGB."""
    w, h = size
    data = _ccitt(variant, h, w)
    try:
        pil_codec.decode(data)
    except Exception:  # noqa: BLE001 - Pillow failing on its own file
        # Pillow cannot read some of its 32771 files (libtiff reads the
        # rows its writer laid out as bad codes); the port fails as well
        assert variant == "rle_word", variant
        with pytest.raises(Exception):
            codecs.decode(data, device="cpu")
        return
    assert_same_still(data)


def _corrupt_strip(data: bytes, seed: int) -> bytes:
    from flyimg_tpu_torch.codecs import tiff

    _, pages = tiff._ifds(data)
    off, count = pages[0][273][0], pages[0][279][0]
    rng = np.random.default_rng(seed)
    buf = bytearray(data)
    for pos in rng.integers(off, off + count, 1 + seed % 4):
        buf[pos] = int(rng.integers(0, 256))
    return bytes(buf)


def _rows_decoded(data: bytes) -> np.ndarray:
    """The rows the port's CCITT decode writes (a strip that ends early
    leaves the rest as they were: found with a buffer of 0xAA bytes)."""
    from flyimg_tpu_torch.codecs import rasterlib, tiff

    _, pages = tiff._ifds(data)
    tags = pages[0]
    w, h = tags[256][0], tags[257][0]
    compression = tags[259][0]
    mode = {2: rasterlib.FAX_RLE, 4: rasterlib.FAX_G4}.get(compression, rasterlib.FAX_G3_1D)
    if compression == 3 and tags.get(292, (0,))[0] & 1:
        mode = rasterlib.FAX_G3_2D
    page = np.full((h, (w + 7) // 8), 0xAA, np.uint8)
    rasterlib.fax_decode(data, [(tags[273][0], tags[279][0], h, 0)], w, mode,
                         tags.get(266, (1,))[0] == 2, page)
    return ~(page == 0xAA).all(axis=1)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("variant", ["g4", "g4_fillorder2", "rle", "g3_1d", "g3_2d",
                                     "g3_fillorder2"])
def test_damaged_ccitt_decodes_as_the_jax_package(variant, seed):
    """Bytes replaced inside a strip: bad codes end a row white to its end,
    a vertical code past the reference line ends it, an uncompressed-mode
    code ends it, a bad code leaves a Group 3 decode out of step to the
    next EOL, an EOL ends a Group 4 strip, and a strip whose data runs out
    fails (modified Huffman, Group 3 2-D inside a row) or is answered
    (Group 4, Group 3 between rows, Group 3 1-D), all as libtiff under
    Pillow answers: where Pillow raises the port raises, and every row the
    decode wrote equals Pillow's. The rows after a strip that ended early
    are not image data in Pillow's answer (its strip buffer as it was, or
    bytes libtiff leaves there; ROADMAP Queue C 17); the port's are 0 bits."""
    data = _corrupt_strip(_ccitt(variant, 157, 203), seed)
    try:
        want = pil_codec.decode(data)
    except Exception:  # noqa: BLE001 - Pillow's own failure
        with pytest.raises(Exception):
            codecs.decode(data, device="cpu")
        return
    got = codecs.decode(data, device="cpu").rgb
    written = _rows_decoded(data)
    np.testing.assert_array_equal(got[written], want.rgb[written])
    # Pillow writes mode "1" min-is-black: 0 bits are black
    assert (got[~written] == 0).all()


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(DATA, "raster"))
    if f.endswith((".bmp", ".ico", ".tif"))))
def test_raster_fixtures_equal_their_pngs(name):
    folder = os.path.join(DATA, "raster")
    with open(os.path.join(folder, name), "rb") as fh:
        data = fh.read()
    stem = name.rsplit(".", 1)[0]
    pages = json.load(open(os.path.join(folder, "reference.json")))[stem]["pages"]
    for page in range(pages):
        png_name = f"{stem}.p{page}.png" if pages > 1 else f"{stem}.png"
        with open(os.path.join(folder, png_name), "rb") as fh:
            rgb, alpha = png.decode(fh.read())
        got = codecs.decode(data, frame=page, device="cpu")
        np.testing.assert_array_equal(got.rgb, rgb)
        assert (got.alpha is None) == (alpha is None)
        if alpha is not None:
            np.testing.assert_array_equal(got.alpha, alpha)
        assert_same_still(data, page)


# ------------------------------------------------------------------ handler


@pytest.fixture(scope="module")
def raster_sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_rasters")
    rgb = photo(300, 360, 14)
    alpha = np.tile(np.linspace(0, 255, 360).astype(np.uint8), (300, 1))
    srcs = {}
    srcs["bmp"] = root / "photo.bmp"
    srcs["bmp"].write_bytes(fb.bmp(rgb, bits=24))
    buf = io.BytesIO()
    Image.fromarray(np.dstack([rgb[:256, :256], alpha[:256, :256]])).save(
        buf, "ICO", sizes=[(64, 64), (256, 256)])
    srcs["ico"] = root / "icon.ico"
    srcs["ico"].write_bytes(buf.getvalue())
    srcs["tiff"] = root / "photo.tif"
    srcs["tiff"].write_bytes(fb.tiff([dict(samples=np.dstack([rgb, alpha]), bits=8,
                                           photometric=2, extra=[2], compression=5,
                                           predictor=2, rows_per_strip=16)]))
    srcs["tiff_be_tiled"] = root / "tiled.tif"
    srcs["tiff_be_tiled"].write_bytes(fb.tiff([dict(samples=rgb, bits=8, photometric=2,
                                                    compression=8, tile=(64, 64))],
                                              big_endian=True))
    srcs["tiff_pages"] = root / "pages.tif"
    srcs["tiff_pages"].write_bytes(fb.tiff([
        dict(samples=photo(160, 200, 15 + k, 40 * k), bits=8, photometric=2, compression=8)
        for k in range(3)]))
    return {k: str(v) for k, v in srcs.items()}


def _handlers(tmp_path):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.handler import ImageHandler

    params = AppParameters({"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t")})
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt")})
    return ImageHandler(params, device="cpu"), JImageHandler(make_storage(jparams), jparams)


@pytest.mark.parametrize("src", ["bmp", "ico", "tiff", "tiff_be_tiled", "tiff_pages"])
@pytest.mark.parametrize("opts", ["w_300,h_250,c_1", "w_120,o_png", "o_gif,w_90"])
def test_raster_sources_answer_as_the_jax_handler(raster_sources, tmp_path, monkeypatch, src,
                                                  opts):
    """A BMP, an ICO and a TIFF source under the reference's crop answer a
    JPEG (o_auto: the MIME the sniff gives is not an output format), with
    the same size and pixels within 30 dB of the JAX handler's; a TIFF of
    three pages answers o_gif with three frames, as the JAX handler does."""
    stand_in.install(monkeypatch)
    handler, jhandler = _handlers(tmp_path)
    got = handler.process_image(opts, raster_sources[src])
    want = jhandler.process_image(opts, raster_sources[src])
    assert got.spec.mime == want.spec.mime
    if "o_" not in opts:
        assert got.spec.mime == "image/jpeg" and stand_in.encode.calls
    gi, wi = (Image.open(io.BytesIO(r.content)) for r in (got, want))
    assert getattr(gi, "n_frames", 1) == getattr(wi, "n_frames", 1)
    g = np.asarray(gi.convert("RGBA")).astype(np.float64)
    w = np.asarray(wi.convert("RGBA")).astype(np.float64)
    assert g.shape == w.shape
    mse = np.mean((g - w) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= HANDLER_PSNR_DB
