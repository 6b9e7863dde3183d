"""Write the WebP fixtures the PyTorch package's VP8 codec is held against.

    JAX_PLATFORMS=cpu python tools/make_webp_fixtures.py [--out tests/data/webp]

The card machine has no libwebp, no Pillow and no JAX. So this script, on a
host that has them, writes what the port's WebP decoder and encoder are
compared with there (``chip_smoke.py`` phase 10) and here
(``tests/test_torch_webp.py``):

- ``small.png``: a seeded 45x67 image (odd sizes); the other source is
  ``tests/data/jpeg/source.png`` (320x240), which
  ``tools/make_jpeg_fixtures.py`` writes;
- lossy WebPs of both written by libwebp:

  - ``pil_<src>_q<q>_m<m>_<rgb|rgba>.webp``: Pillow at quality 10, 50, 90
    and 100 and method 0, 4 and 6, RGB and RGBA (a smooth alpha plane);
  - ``api_<name>.webp``: this host's libwebp through its advanced API
    (``WebPConfig`` by ``ctypes``), one file for each decoder path Pillow
    does not choose: the simple loop filter, sharpness, 1 and 4 segments,
    2, 4 and 8 token partitions, no filter, a strong filter;
  - ``alph_<raw|vp8l>_<filter>.webp``: an ALPH chunk of compression 0 and
    1 with each of the container's filters (none, horizontal, vertical,
    gradient): libwebp's VP8 frame and libwebp's unfiltered alpha stream of
    the filtered plane, the chunk's header naming the filter;

- each of them decoded by the JAX package (``flyimg_tpu.codecs.decode``,
  libwebp's WebPDecodeRGB(A)), as ``<name>.png`` (RGBA when it has alpha);
- the JAX package's lossy encodes (``flyimg_tpu.codecs.encode``) at
  quality 50, 75 and 90 of ``source.png`` and of its ``w_300,h_250,c_1``
  answer (the JAX package's pipeline, ``answer.png``: 300x240, as the
  reference does not upscale), as
  ``jax_<source|answer>_q<q>.webp``;
- ``reference.json``: for each JAX encode its bytes and ``psnr``, its PSNR
  against the pixels it encoded after the JAX package's own decode.

``tests/test_torch_webp.py`` rebuilds all of it and fails if a file
differs, so the fixtures stay libwebp's and the JAX package's answers.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "webp")
QUALITIES = (10, 50, 90, 100)
METHODS = (0, 4, 6)
JAX_QUALITIES = (50, 75, 90)
ANSWER_OPTIONS = "w_300,h_250,c_1"
#: libwebp's advanced-API settings, one file each (on source.png, q 75)
API_FILES = {
    "simple_filter": dict(filter_type=0),
    "simple_filter_sharpness6": dict(filter_type=0, filter_sharpness=6),
    "normal_filter_sharpness3": dict(filter_type=1, filter_sharpness=3),
    "strong_filter_q5": dict(quality=5, filter_strength=100),
    "no_filter": dict(filter_strength=0),
    "segments1": dict(segments=1),
    "segments4_sns100": dict(segments=4, sns_strength=100),
    # libwebp writes one token partition from method 3 on
    "partitions2": dict(partitions=1, method=2),
    "partitions4": dict(partitions=2, method=2),
    "partitions8": dict(partitions=3, method=0),
}
ALPHA_FILTERS = ("none", "horizontal", "vertical", "gradient")


def small_image() -> np.ndarray:
    rng = np.random.default_rng(45)
    yy, xx = np.mgrid[0:45, 0:67].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(yy / (3.0 + c) + c) * np.cos(xx / (5.0 + 2 * c))
                    for c in range(3)], -1)
    img[10:30, 20:40] = (30.0, 220.0, 90.0)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def alpha_plane(h: int, w: int) -> np.ndarray:
    """A smooth alpha plane: opaque, transparent and graded regions."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.hypot((yy - 0.4 * h) / h, (xx - 0.6 * w) / w)
    a = np.clip(400 * (0.55 - r), 0, 255)
    a[: h // 6, : w // 5] = 0
    return a.astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


# --------------------------------------------------------------------------
# libwebp's advanced encoding API by ctypes

ENCODER_ABI = 0x020F  # libwebp compares the major byte only


class _Picture(ctypes.Structure):
    """``WebPPicture`` (encode.h), with room to spare at its end."""

    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
        ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3),
        ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
        ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
        ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
        ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
        ("spare", ctypes.c_uint8 * 256),
    ]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 8)]


#: ``WebPConfig`` field -> index among its 4-byte fields (encode.h order)
_CONFIG = {name: k for k, name in enumerate((
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
    "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
    "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
    "show_compressed", "preprocessing", "partitions", "partition_limit",
    "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv"))}


def libwebp_encode(pixels: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """[h, w, 3|4] uint8 -> a lossy WebP by this host's libwebp, with
    ``WebPConfig`` fields set by name (default preset otherwise)."""
    lib = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so")
    config = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(config, 0, ctypes.c_float(quality), ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    for name, value in settings.items():
        config[_CONFIG[name]] = int(value)
    if not lib.WebPValidateConfig(config):
        raise RuntimeError(f"libwebp refused the settings {settings}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, ch = pixels.shape
    pic.width, pic.height = w, h
    importer = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not importer(ctypes.byref(pic), pixels.ctypes.data_as(ctypes.c_void_p), w * ch):
            raise RuntimeError("WebPPictureImport failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        pic.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(config, ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


# --------------------------------------------------------------------------
# the container


def chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a RIFF/WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def riff(parts: list) -> bytes:
    body = b"".join(fourcc + len(p).to_bytes(4, "little") + p + b"\0" * (len(p) & 1)
                    for fourcc, p in parts)
    return b"RIFF" + (4 + len(body)).to_bytes(4, "little") + b"WEBP" + body


def filter_alpha(alpha: np.ndarray, method: int) -> np.ndarray:
    """The container's forward alpha filter: each value minus its
    prediction (left, above or the clipped gradient; the first row from the
    left, the first column from above, the first value from 0), mod 256."""
    a = alpha.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method > 0:
        pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph_file(rgb: np.ndarray, alpha: np.ndarray, compression: int, method: int) -> bytes:
    """VP8X + ALPH + VP8: libwebp's frame of ``rgb`` and libwebp's
    unfiltered alpha chunk of the filtered plane, its header naming
    ``method``."""
    deltas = filter_alpha(alpha, method)
    data = libwebp_encode(np.dstack([rgb, deltas]), 75.0, alpha_compression=compression,
                          alpha_filtering=0)
    parts = dict(chunks(data))
    alph = parts[b"ALPH"]
    assert alph[0] == compression, alph[0]
    return riff([(b"VP8X", parts[b"VP8X"]), (b"ALPH", bytes([compression | method << 2]) + alph[1:]),
                 (b"VP8 ", parts[b"VP8 "])])


# --------------------------------------------------------------------------


def answer_image(src: np.ndarray) -> np.ndarray:
    """The JAX package's ``w_300,h_250,c_1`` answer of ``src``."""
    from flyimg_tpu.ops.compose import run_plan
    from flyimg_tpu.spec.options import OptionsBag
    from flyimg_tpu.spec.plan import build_plan

    plan = build_plan(OptionsBag(ANSWER_OPTIONS), src.shape[1], src.shape[0])
    return np.asarray(run_plan(src, plan), dtype=np.uint8)


def build() -> dict:
    """name -> bytes of every fixture file."""
    from PIL import Image

    import flyimg_tpu.codecs as jcodecs
    from tools.make_jpeg_fixtures import source_image

    def png_bytes(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()

    def decoded_png(data):
        d = jcodecs.decode(data)
        return png_bytes(d.rgb if d.alpha is None else np.dstack([d.rgb, d.alpha]))

    sources = {"source": source_image(), "small": small_image()}
    files = {"small.png": png_bytes(sources["small"])}
    webps = {}
    for tag, img in sources.items():
        rgba = np.dstack([img, alpha_plane(*img.shape[:2])])
        for q in QUALITIES:
            for m in METHODS:
                for mode, px in (("rgb", img), ("rgba", rgba)):
                    buf = io.BytesIO()
                    Image.fromarray(px).save(buf, "WEBP", quality=q, method=m)
                    webps[f"pil_{tag}_q{q}_m{m}_{mode}"] = buf.getvalue()
    src = sources["source"]
    for name, settings in API_FILES.items():
        webps[f"api_{name}"] = libwebp_encode(src, **settings)
    small = sources["small"]
    for compression, kind in ((0, "raw"), (1, "vp8l")):
        for method, fname in enumerate(ALPHA_FILTERS):
            webps[f"alph_{kind}_{fname}"] = alph_file(small, alpha_plane(*small.shape[:2]),
                                                     compression, method)
    for name, data in webps.items():
        files[f"{name}.webp"] = data
        files[f"{name}.png"] = decoded_png(data)
    answer = answer_image(src)
    files["answer.png"] = png_bytes(answer)
    encodes = {}
    for tag, px in (("source", src), ("answer", answer)):
        for q in JAX_QUALITIES:
            blob = jcodecs.encode(px, "webp", quality=q, webp_lossless=False)
            name = f"jax_{tag}_q{q}.webp"
            files[name] = blob
            encodes[f"{tag}_q{q}"] = {"bytes": len(blob), "file": name,
                                      "psnr": round(psnr(jcodecs.decode(blob).rgb, px), 4)}
    ref = {"answer_options": ANSWER_OPTIONS, "encodes": encodes,
           "sources": {"source": "../jpeg/source.png", "small": "small.png",
                       "answer": "answer.png"}}
    files["reference.json"] = (json.dumps(ref, indent=1, sort_keys=True) + "\n").encode()
    return files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, data in build().items():
        with open(os.path.join(args.out, name), "wb") as fh:
            fh.write(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
