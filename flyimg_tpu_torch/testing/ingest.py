"""Sources of the ingestion check: a Letter scan as a two-page PDF, a
bilevel page, and a container a sniff reads as a video.

Everything is made from seeded numpy and assembled byte by byte (zlib, no
PDF or TIFF library), so ``chip_smoke.py`` phase 16 builds the same bytes
on the card machine as ``tools/make_ingest_fixtures.py`` does where the
JAX package's references are computed: the scan's JPEG comes from the
port's own encoder (``moz_0``), whose bytes are the same on a card and on
the CPU.
"""

from __future__ import annotations

import zlib

import numpy as np

#: Letter at 300 dpi
SCAN_W, SCAN_H = 2550, 3300


def scan_rgb(w: int = SCAN_W, h: int = SCAN_H, seed: int = 1600) -> np.ndarray:
    """A seeded page scan: paper with a soft gradient, lines of dark
    strokes (text-like), a photo block and faint noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    paper = 236 + 10 * np.sin(yy / 431.0) * np.cos(xx / 377.0)
    img = np.repeat(paper[..., None], 3, axis=2)
    img[..., 2] -= 6
    line_h = max(h // 60, 4)
    for top in range(h // 10, h * 9 // 10, line_h * 2):
        words = rng.integers(0, 2, -(-w // 40)).astype(bool)
        cols = np.repeat(words, 40)[:w]
        band = slice(top, min(top + line_h, h))
        stroke = (np.sin(xx[band] / 3.1 + top) > 0.2) & cols[None, :]
        img[band][stroke] = (35.0, 38.0, 52.0)
    y0, y1, x0, x1 = h // 8, h // 3, w // 2, w * 7 // 8
    img[y0:y1, x0:x1, 0] = 120 + 90 * np.sin(yy[y0:y1, x0:x1] / 41.0)
    img[y0:y1, x0:x1, 1] = 140 + 70 * np.cos(xx[y0:y1, x0:x1] / 53.0)
    img[y0:y1, x0:x1, 2] = 110 + 60 * np.sin((xx + yy)[y0:y1, x0:x1] / 67.0)
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def scan_alpha(w: int = SCAN_W, h: int = SCAN_H) -> np.ndarray:
    """The scan's soft mask: opaque, fading to half at the page's right and
    to clear in a band at the foot."""
    xx = np.arange(w, dtype=np.int64)[None, :]
    yy = np.arange(h, dtype=np.int64)[:, None]
    alpha = 255 - (xx * 128 // max(w - 1, 1))
    alpha = np.where(yy > h * 15 // 16, alpha * (h - 1 - yy) // max(h // 16, 1), alpha)
    return np.clip(alpha, 0, 255).astype(np.uint8)


def _stream(data: bytes, head: bytes) -> bytes:
    return b"<< %s /Length %d >>stream\n" % (head, len(data)) + data + b"\nendstream\n"


def letter_pdf(jpeg: bytes, w: int, h: int, alpha: np.ndarray) -> bytes:
    """A two-page Letter PDF of one DCTDecode image (``w`` x ``h``) with a
    FlateDecode SMask (``alpha``): page 1 draws it over the whole page,
    page 2 inset at two thirds of the page, rotated 90 degrees by
    ``/Rotate``."""
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Count 2 /Kids [3 0 R 4 0 R] >>",
        3: b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
           b"/Resources << /XObject << /scan 5 0 R >> >> /Contents 7 0 R >>",
        4: b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Rotate 90 "
           b"/Resources << /XObject << /scan 5 0 R >> >> /Contents 8 0 R >>",
        5: _stream(jpeg, b"/Type /XObject /Subtype /Image /Width %d /Height %d "
                         b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
                         b"/SMask 6 0 R" % (w, h)),
        6: _stream(zlib.compress(np.ascontiguousarray(alpha, np.uint8).tobytes(), 6),
                   b"/Type /XObject /Subtype /Image /Width %d /Height %d "
                   b"/ColorSpace /DeviceGray /BitsPerComponent 8 /Filter /FlateDecode"
                   % (alpha.shape[1], alpha.shape[0])),
        7: _stream(b"q 612 0 0 792 0 0 cm /scan Do Q", b""),
        8: _stream(b"q 408 0 0 528 102 132 cm /scan Do Q", b""),
    }
    out = [b"%PDF-1.4\n"]
    for num, body in objs.items():
        out.append(b"%d 0 obj\n" % num + body + b"endobj\n")
    out.append(b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")
    return b"".join(out)


def fax_page(w: int = SCAN_W, h: int = SCAN_H, seed: int = 1700) -> np.ndarray:
    """A seeded bilevel page (0 black, 255 white): lines of text-like
    strokes, rules and a dithered block, as a fax or an archive scan."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    xx = np.arange(w)
    line_h = max(h // 80, 3)
    for top in range(h // 12, h * 11 // 12, line_h * 2):
        words = rng.integers(0, 3, -(-w // 32)) > 0
        cols = np.repeat(words, 32)[:w] & ((xx // 3 + top) % 5 != 0)
        rows = np.arange(line_h)[:, None]
        strokes = (np.sin(xx / 2.3 + top)[None, :] > 0.1) | (rows == line_h // 2)
        page[top:top + line_h][strokes & cols[None, :]] = 0
    page[h // 20:h // 20 + 6] = 0
    y0, y1, x0, x1 = h // 2, h // 2 + h // 8, w // 6, w // 3
    level = np.linspace(0, 1, x1 - x0)[None, :]
    page[y0:y1, x0:x1] = np.where(rng.random((y1 - y0, x1 - x0)) < level, 255, 0)
    return page


#: a file the sniff reads as video/mp4: an ISO base media "ftyp" box and an
#: empty "mdat" (no decodable frame)
MP4_STUB = (b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isommp41"
            b"\x00\x00\x00\x08mdat")
