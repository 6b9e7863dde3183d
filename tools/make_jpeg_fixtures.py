"""Write the JPEG fixtures the PyTorch package's JPEG decoders are held
against.

    JAX_PLATFORMS=cpu python tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

The port's decoder runs its kernels on a card, and the card machine has
neither the JAX package's codecs (Pillow, libjpeg) nor JAX. So this script,
on a host that has them (and g++ with libjpeg's headers), writes what the
card's checks compare with:

- ``source.png``: a seeded 320x240 photo-like image;
- JPEGs of it written by the JAX package's encoder (``flyimg_tpu.codecs
  .encode``, q90 baseline): 4:2:0, 4:4:4, progressive 4:2:0 and 4:2:0
  with EXIF orientation 6 in an APP1 segment;
- the other layouts a card must decode, written by Pillow at q90: a
  grayscale JPEG (one component), an Adobe CMYK JPEG (four components,
  APP14 transform 0; its K is 255 - max(R, G, B)) and a YCCK one (the
  CMYK file with its APP14 transform set to 2: the same coded planes,
  which libjpeg then reads as YCC + K; no tool on the host that writes
  the fixtures encodes YCCK itself); the CMYK JPEG with subsampled
  components (Pillow's subsampling 1 and 2: sampling factors (2,1) and
  (2,2) for C, (1,1) for M, Y and K), the (2,2) one also as YCCK by the
  same APP14 byte; and an RGB-coded JPEG (``keep_rgb``: three components
  stored as R, G, B, APP14 transform 0, no JFIF segment);
- each JPEG decoded by the JAX package (``flyimg_tpu.codecs.decode``), as
  ``<name>.s8.png``, and the 4:2:0 one also at the DCT scales 1, 2 and 4
  of 8 that target hints pick (``<name>.s<k>.png``);
- ``photo1000x750_rst.jpg``: a seeded 1000x750 4:2:0 photo with a restart
  interval (a row of MCUs), written by Pillow at q90;
- the JAX package's NATIVE-route decodes (``fc_jpeg_decode``, built from
  the unmodified ``fastcodec.cpp`` into a temporary directory): every
  JPEG at DCT scales 1, 2, 4 and 8 as ``<name>.native.s<k>.png``, and
  windows of four of them at each scale (``fc_jpeg_decode_roi``) as
  ``<name>.native.s<k>.w<i>.png``, each window's request, origin and frame
  size under ``native_windows`` in ``reference.json``;
- the JAX package's q90 encodes of the source with moz_0 and moz_1
  (4:4:4), as ``encode_q90_444_moz<k>.jpg``;
- ``README.md``: what wrote each file, and which route of the JAX
  package's encoder wrote the encodes;
- ``reference.json``: those hints, and for each encode its bytes and
  ``psnr_libjpeg``, its PSNR against the source after the JAX package's
  own decode (libjpeg-turbo, through Pillow). A card compares the PyTorch
  package's encode with the JAX package's file after one decoder, nvJPEG,
  on both (``chip_smoke.py`` phase 10), so no decoder's error is taken
  for an encoder's.

``tests/test_torch_codecs.py`` rebuilds all of it and fails if a file
differs, so the fixtures stay the JAX package's answers.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "jpeg")
#: DCT scale (of 8) -> a target hint that picks it for a 320x240 source
SCALE_HINTS = {1: (20, 15), 2: (40, 30), 4: (80, 60)}


def source_image() -> np.ndarray:
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    img = np.stack([118 + 80 * np.sin(yy / (19.0 + 6 * c) + c) * np.cos(xx / 33.0 - c)
                    for c in range(3)], -1)
    img[60:140, 180:260] = (200.0, 146.0, 112.0)     # a sharp-edged block
    img[::16] *= 0.6                                  # fine stripes
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


#: the layouts other than YCbCr (see ``layouts``)
LAYOUTS = ("q90_gray", "q90_cmyk", "q90_ycck", "q90_cmyk_h2v1", "q90_cmyk_h2v2",
           "q90_ycck_h2v2", "q90_rgb_adobe0")


def _as_ycck(data: bytes) -> bytes:
    """An Adobe JPEG with its APP14 transform byte set to 2 (YCCK)."""
    out = bytearray(data)
    at = out.index(b"\xff\xee\x00\x0eAdobe")
    out[at + 15] = 2
    return bytes(out)


def layouts(src: np.ndarray) -> dict:
    """name -> bytes of the gray, Adobe CMYK and YCCK (whole and with
    subsampled components) and RGB-coded JPEGs of ``src``."""
    from PIL import Image

    def save(arr, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "JPEG", quality=90, **kw)
        return buf.getvalue()

    x = src.astype(np.int32)
    k = 255 - x.max(-1)
    cmyk = np.concatenate([255 - x - k[..., None], k[..., None]], -1).astype(np.uint8)
    out = {"q90_gray": save(np.asarray(Image.fromarray(src).convert("L")), "L"),
           "q90_cmyk": save(cmyk, "CMYK"),
           "q90_cmyk_h2v1": save(cmyk, "CMYK", subsampling=1),
           "q90_cmyk_h2v2": save(cmyk, "CMYK", subsampling=2),
           "q90_rgb_adobe0": save(src, "RGB", keep_rgb=True)}
    out["q90_ycck"] = _as_ycck(out["q90_cmyk"])
    out["q90_ycck_h2v2"] = _as_ycck(out["q90_cmyk_h2v2"])
    return out


def photo_image(w: int = 1000, h: int = 750) -> np.ndarray:
    """A seeded photo-like image: smooth colour fields, a sharp block, low
    noise (so its PNG decodes stay small)."""
    rng = np.random.default_rng(1000)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([124 + 84 * np.sin(yy / (41.0 + 13 * c) + c) * np.cos(xx / (67.0 - 9 * c))
                    for c in range(3)], -1)
    img[h // 3:h // 2, w // 4:w // 2] = (214.0, 162.0, 96.0)
    return np.clip(img + rng.normal(0, 1.5, img.shape), 0, 255).astype(np.uint8)


#: the files whose windows are written, and each window as a fraction of
#: the scaled frame: (x, y, w, h)
WINDOW_SOURCES = ("q90_420", "q90_420_progressive", "q90_444", "photo1000x750_rst")
WINDOWS = ((0.3, 0.25, 0.4, 0.5), (0.6, 0.0, 0.7, 0.3))


class NativeDecoder:
    """The JAX package's native JPEG decodes (``fc_jpeg_decode``,
    ``fc_jpeg_decode_roi``) from a library built of its unmodified
    fastcodec.cpp."""

    def __init__(self, path: str):
        import ctypes

        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.fc_jpeg_decode.restype = p
        lib.fc_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i, ip, ip]
        lib.fc_jpeg_decode_roi.restype = p
        lib.fc_jpeg_decode_roi.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i, i, i, i, i,
                                           ip, ip, ip, ip, ip, ip]
        lib.fc_free.argtypes = [p]
        lib.fc_free.restype = None
        self.lib, self.ctypes = lib, ctypes

    def _take(self, ptr, w, h):
        try:
            pixels = np.frombuffer(self.ctypes.string_at(ptr, w * h * 3), np.uint8)
            return pixels.reshape(h, w, 3).copy()
        finally:
            self.lib.fc_free(ptr)

    def decode(self, data: bytes, scale_num: int = 8):
        """fc_jpeg_decode: [h, w, 3] uint8, or None where it fails."""
        c = self.ctypes
        w, h = c.c_int(), c.c_int()
        ptr = self.lib.fc_jpeg_decode(data, len(data), scale_num, c.byref(w), c.byref(h))
        return self._take(ptr, w.value, h.value) if ptr else None

    def decode_roi(self, data: bytes, scale_num: int, roi):
        """fc_jpeg_decode_roi with roi = (x, y, w, h): (rgb, (out_x, out_y),
        (full_w, full_h)), or None where it fails."""
        c = self.ctypes
        out = [c.c_int() for _ in range(6)]
        ptr = self.lib.fc_jpeg_decode_roi(data, len(data), scale_num, *[int(v) for v in roi],
                                          *[c.byref(v) for v in out])
        if not ptr:
            return None
        w, h, x, y, fw, fh = (v.value for v in out)
        return self._take(ptr, w, h), (x, y), (fw, fh)


def native_decodes(jpegs: dict, png_bytes) -> tuple:
    """(files, windows): each JPEG's native-route decode at every DCT scale,
    and the windows of WINDOW_SOURCES, through a fastcodec built in a
    temporary directory."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "make_jpeg_encode_fixtures", os.path.join(ROOT, "tools", "make_jpeg_encode_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    reason = tool.missing()
    if reason:
        raise RuntimeError(f"the JAX package's native codec cannot be built here: {reason}")
    files, windows = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        native = NativeDecoder(tool.build_fastcodec(tmp))
        for name, data in sorted(jpegs.items()):
            for scale in (1, 2, 4, 8):
                files[f"{name}.native.s{scale}.png"] = png_bytes(native.decode(data, scale))
                if name not in WINDOW_SOURCES:
                    continue
                full = native.decode(data, scale)
                fh, fw = full.shape[:2]
                for i, frac in enumerate(WINDOWS):
                    request = [int(frac[0] * fw), int(frac[1] * fh),
                               max(1, int(frac[2] * fw)), max(1, int(frac[3] * fh))]
                    rgb, (x, y), (full_w, full_h) = native.decode_roi(data, scale, request)
                    file = f"{name}.native.s{scale}.w{i}.png"
                    files[file] = png_bytes(rgb)
                    windows.append({"source": f"{name}.jpg", "scale": scale,
                                    "request": request, "file": file, "out_x": x,
                                    "out_y": y, "full_w": full_w, "full_h": full_h})
    return files, windows


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def build() -> dict:
    """name -> bytes of every fixture file."""
    from PIL import Image

    import flyimg_tpu.codecs as jcodecs

    def png_bytes(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()

    src = source_image()
    files = {"source.png": png_bytes(src)}
    exif = Image.Exif()
    exif[0x0112] = 6
    jpegs = {
        "q90_420": dict(subsampling=2),
        "q90_444": dict(subsampling=0),
        "q90_420_progressive": dict(subsampling=2, progressive=True),
        "q90_420_orient6": dict(subsampling=2, exif=exif),
    }
    for name, kw in jpegs.items():
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "JPEG", quality=90, **kw)
        files[f"{name}.jpg"] = buf.getvalue()
    for name, data in layouts(src).items():
        files[f"{name}.jpg"] = data
    buf = io.BytesIO()
    Image.fromarray(photo_image()).save(buf, "JPEG", quality=90, subsampling=2,
                                        restart_marker_rows=1)
    files["photo1000x750_rst.jpg"] = buf.getvalue()
    for name in list(jpegs) + list(LAYOUTS):
        files[f"{name}.s8.png"] = png_bytes(jcodecs.decode(files[f"{name}.jpg"]).rgb)
    for scale, hint in SCALE_HINTS.items():
        data = files["q90_420.jpg"]
        files[f"q90_420.s{scale}.png"] = png_bytes(jcodecs.decode(data, target_hint=hint).rgb)
    encodes = {}
    for moz in (0, 1):
        blob = jcodecs.encode(src, "jpg", quality=90, mozjpeg=bool(moz), sampling_factor="1x1")
        back = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        files[f"encode_q90_444_moz{moz}.jpg"] = blob
        encodes[f"moz_{moz}"] = {"bytes": len(blob), "file": f"encode_q90_444_moz{moz}.jpg",
                                 "psnr_libjpeg": round(psnr(back, src), 4)}
    native, windows = native_decodes(
        {n[:-4]: d for n, d in files.items() if n.endswith(".jpg")}, png_bytes)
    files.update(native)
    ref = {"scale_hints": {str(k): list(v) for k, v in SCALE_HINTS.items()},
           "encode_q90_444": encodes, "native_windows": windows}
    files["reference.json"] = (json.dumps(ref, indent=1, sort_keys=True) + "\n").encode()
    files["README.md"] = readme(jcodecs.native_codec.available()).encode()
    return files


def readme(native: bool) -> str:
    """The fixture directory's README: what wrote each file, and by which of
    the JAX package's JPEG routes the encodes came."""
    route = ("its native library (``fc_jpeg_encode_trellis`` for moz_1, "
             "``fc_jpeg_encode`` for moz_0)" if native else
             "its Pillow fallback: `libfastcodec.so` did not load where they were "
             "written, so `encode_q90_444_moz1.jpg` has optimized Huffman tables "
             "and progressive scans but no trellis quantization")
    return (
        "# JPEG fixtures (written by tools/make_jpeg_fixtures.py)\n\n"
        "- `source.png`: a seeded 320x240 photo-like image.\n"
        "- `q90_*.jpg`: JPEGs the port's decoders are held to (4:2:0, 4:4:4, "
        "progressive, EXIF orientation 6, gray, Adobe CMYK and YCCK, subsampled CMYK "
        "and YCCK, RGB-coded), and `<name>.s<k>.png` the JAX package's decode of each "
        "at DCT scale k of 8 through `flyimg_tpu.codecs.decode`, which here takes its "
        "Pillow route (the nvJPEG yardstick is held to these).\n"
        "- `photo1000x750_rst.jpg`: a seeded 1000x750 4:2:0 photo with a restart "
        "interval, written by Pillow at q90.\n"
        "- `<name>.native.s<k>.png`: the JAX package's NATIVE-route decode of every "
        "JPEG at DCT scale k of 8 (`fc_jpeg_decode`, libjpeg-turbo 2.1 built from the "
        "unmodified `fastcodec.cpp`), and `<name>.native.s<k>.w<i>.png` windows "
        "(`fc_jpeg_decode_roi`; each request, origin and frame size under "
        "`native_windows` in `reference.json`): what the port's own decoder equals "
        "with max difference 0.\n"
        "- Where the two routes differ: the Pillow route converts CMYK and YCCK with "
        "Pillow's (255 - K) - C (255 - K) / 255 in integers after reading the inverted "
        "samples; the native route folds them with `fastcodec.cpp`'s c * k / 255. The "
        "`q90_cmyk*` and `q90_ycck*` decodes therefore differ between `.s8.png` and "
        "`.native.s8.png`; the YCbCr, gray and RGB-coded ones are the same "
        "libjpeg-turbo decode (a CPU test counts where they differ).\n"
        "- `encode_q90_444_moz<k>.jpg`: the JAX package's `flyimg_tpu.codecs.encode` of "
        f"the source at q90 4:4:4, through {route}.\n"
        "- `reference.json`: the scale hints, each encode's bytes and PSNR, and the "
        "native windows.\n\n"
        "The native route's bytes, which the port's own JPEG encoder is held to, are "
        "in `tests/data/jpeg_enc` (tools/make_jpeg_encode_fixtures.py).\n"
    )


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
