"""Write tests/data/ingest: the sources of ``chip_smoke.py`` phase 16 and
the JAX package's decodes of them.

    JAX_PLATFORMS=cpu python tools/make_ingest_fixtures.py

Needs g++, libjpeg's headers and Pillow (here, not on the card machine).
Writes:

- ``arith_progressive_2048x1536.jpg``: an arithmetic-coded progressive
  JPEG (SOF10, 4:2:0, q85) of a seeded photo, by libjpeg
  (``tests/jpeg_test_files.py``'s encoder);
- ``strips.tif``: a 1024x768 RGB TIFF in JPEG-compressed strips, by Pillow
  (libtiff);
- ``g4_page.tif``: a 2550x3300 bilevel page in CCITT Group 4, by Pillow;
- ``reference.json``: the SHA-256 of the JAX package's decodes of each
  (its native ``fc_jpeg_decode`` at 1/1 and 1/4 for the JPEG, built from
  the unmodified ``fastcodec.cpp``; ``pil_codec.decode`` for the TIFFs),
  and of its ``MiniPdf.rasterize`` of the Letter scan PDF that
  ``flyimg_tpu_torch/testing/ingest.py`` assembles around the port's own
  JPEG encode of ``scan_rgb()`` (page 1 at 96 dpi, page 2 at 150), with
  the SHA-256 of that JPEG's bytes.

Pixels are hashed as their uint8 bytes, row-major, with the shape beside.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "ingest")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

#: the scan JPEG's encode (the port's moz_0, 4:2:0)
SCAN_QUALITY = 85
#: the PDF pages phase 16 serves: (page, density)
PDF_PAGES = ((1, 96), (2, 150))


def digest(pixels: np.ndarray) -> dict:
    pixels = np.ascontiguousarray(pixels, np.uint8)
    return {"shape": list(pixels.shape), "sha256": hashlib.sha256(pixels.tobytes()).hexdigest()}


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """A smooth seeded photo (fields, edges, faint noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (97.0 + 31 * c) + c) * np.cos(xx / (131.0 - 17 * c))
                    for c in range(3)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = (220.0, 40.0, 90.0)
    img += rng.normal(0, 1.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def scan_jpeg() -> bytes:
    """The port's JPEG of the Letter scan (CPU; byte-equal on a card)."""
    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.testing import ingest

    return codecs.encode(ingest.scan_rgb(), "jpg", quality=SCAN_QUALITY, mozjpeg=False,
                         sampling_factor="2x2", device="cpu")


def main() -> int:
    import jpeg_test_files as jt
    from PIL import Image

    from flyimg_tpu.codecs import native_codec as jax_native
    from flyimg_tpu.codecs import pil_codec
    from flyimg_tpu.codecs.pdf_mini import MiniPdf
    from flyimg_tpu_torch.testing import ingest

    spec = importlib.util.spec_from_file_location(
        "make_jpeg_encode_fixtures", os.path.join(ROOT, "tools", "make_jpeg_encode_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    reason = tool.missing()
    if reason:
        print(f"cannot build the JAX package's native codec: {reason}", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = tool.build_fastcodec(tmp)
        native = jt.Native(lib)
        enc = jt.encoder(tmp)
        arith = enc(photo(2048, 1536, 1601), 85, (2, 2), True, 0, arith=True)
        with open(os.path.join(OUT, "arith_progressive_2048x1536.jpg"), "wb") as fh:
            fh.write(arith)
        ref["arith_progressive_2048x1536.jpg"] = {
            f"s{s}": digest(native.decode(arith, s)) for s in (8, 2)}

        buf = io.BytesIO()
        Image.fromarray(photo(1024, 768, 1602)).save(buf, "TIFF", compression="jpeg",
                                                      quality=85)
        with open(os.path.join(OUT, "strips.tif"), "wb") as fh:
            fh.write(buf.getvalue())
        ref["strips.tif"] = digest(pil_codec.decode(buf.getvalue()).rgb)

        buf = io.BytesIO()
        Image.fromarray(ingest.fax_page()).convert("1").save(buf, "TIFF", compression="group4")
        with open(os.path.join(OUT, "g4_page.tif"), "wb") as fh:
            fh.write(buf.getvalue())
        ref["g4_page.tif"] = digest(pil_codec.decode(buf.getvalue()).rgb)

        # the JAX rasterizer decodes the DCT image with its native library
        jax_native._LIB_PATH = lib
        jax_native._lib = None
        jpeg = scan_jpeg()
        pdf = ingest.letter_pdf(jpeg, ingest.SCAN_W, ingest.SCAN_H, ingest.scan_alpha())
        doc = MiniPdf(pdf)
        ref["letter_scan.pdf"] = {
            "jpeg_sha256": hashlib.sha256(jpeg).hexdigest(),
            "pdf_sha256": hashlib.sha256(pdf).hexdigest(),
            "pages": {f"p{page}-d{dpi}": digest(doc.rasterize(page, dpi))
                      for page, dpi in PDF_PAGES}}
    with open(os.path.join(OUT, "reference.json"), "w") as fh:
        json.dump(ref, fh, indent=1, sort_keys=True)
        fh.write("\n")
    sizes = {f: os.path.getsize(os.path.join(OUT, f)) for f in sorted(os.listdir(OUT))}
    print(json.dumps(sizes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
