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
    """Pillow decodes these (ROADMAP Queue A 3 lists them); the port answers
    415 naming the compression."""
    img = Image.fromarray(photo(H, W, 13)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    assert pil_codec.decode(buf.getvalue()).rgb.shape == (H, W, 3)
    with pytest.raises(UnsupportedMediaException, match=f"TIFF compression {name}"):
        codecs.decode(buf.getvalue(), device="cpu")


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
