"""Write the JPEG fixtures the PyTorch package's nvJPEG is held against.

    JAX_PLATFORMS=cpu python tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

nvJPEG runs on a card, and the card machine has neither the JAX package's
codecs (Pillow, libjpeg) nor JAX. So this script, on a host that has them,
writes what the card's tests compare with:

- ``source.png``: a seeded 320x240 photo-like image;
- JPEGs of it written by the JAX package's encoder (``flyimg_tpu.codecs
  .encode``, q90 baseline): 4:2:0, 4:4:4, progressive 4:2:0 and 4:2:0
  with EXIF orientation 6 in an APP1 segment;
- the other layouts a card must decode, written by Pillow at q90: a
  grayscale JPEG (one component), an Adobe CMYK JPEG (four components,
  APP14 transform 0; its K is 255 - max(R, G, B)) and a YCCK one (the
  CMYK file with its APP14 transform set to 2: the same coded planes,
  which libjpeg then reads as YCC + K). No tool on the host that writes
  the fixtures encodes YCCK itself;
- each JPEG decoded by the JAX package (``flyimg_tpu.codecs.decode``), as
  ``<name>.s8.png``, and the 4:2:0 one also at the DCT scales 1, 2 and 4
  of 8 that target hints pick (``<name>.s<k>.png``);
- the JAX package's q90 encodes of the source with moz_0 and moz_1
  (4:4:4), as ``encode_q90_444_moz<k>.jpg``;
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


#: the one-component and four-component fixtures (see ``layouts``)
LAYOUTS = ("q90_gray", "q90_cmyk", "q90_ycck")


def layouts(src: np.ndarray) -> dict:
    """name -> bytes of the gray, Adobe CMYK and YCCK JPEGs of ``src``."""
    from PIL import Image

    def save(arr, mode):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    x = src.astype(np.int32)
    k = 255 - x.max(-1)
    cmyk = np.concatenate([255 - x - k[..., None], k[..., None]], -1).astype(np.uint8)
    out = {"q90_gray": save(np.asarray(Image.fromarray(src).convert("L")), "L"),
           "q90_cmyk": save(cmyk, "CMYK")}
    data = bytearray(out["q90_cmyk"])
    at = data.index(b"\xff\xee\x00\x0eAdobe")
    data[at + 15] = 2               # APP14's transform byte: YCCK
    out["q90_ycck"] = bytes(data)
    return out


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
    ref = {"scale_hints": {str(k): list(v) for k, v in SCALE_HINTS.items()},
           "encode_q90_444": encodes}
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
