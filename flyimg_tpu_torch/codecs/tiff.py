"""TIFF sources for the port's host codec layer.

The JAX package decodes a TIFF through Pillow (libtiff for compressed
data); the card machine has neither. This module reads what they read, with
Pillow's mode choice, so a decode equals Pillow's:

- both byte orders; strips and tiles; one page a seek (``gf_N``);
- compressions: none, PackBits, LZW (MSB-first, early change;
  ``codecs/native/gif.cpp``) and Deflate (zlib), each with predictor 1 or 2
  (horizontal differencing of 8- and 16-bit samples);
- layouts: bilevel (1-bit, either photometric), 8-bit gray (min-is-black or
  min-is-white), 16-bit gray (saturating at 255, as Pillow converts it),
  gray with alpha, RGB, RGB with an unused extra sample, RGBA (associated
  alpha unpremultiplied as Pillow's ``RGBa`` unpack does, unassociated and
  unspecified alpha as is), 16-bit RGB and RGBA (their high bytes), and a
  palette of 1, 2, 4 or 8 bits (the colour map's high bytes), with alpha;
- the orientation tag (274) turns the page upright.

Any other compression (JPEG, CCITT and the rest) or layout raises
``UnsupportedMediaException`` naming it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import rasterlib
from flyimg_tpu_torch.codecs.exif import apply_orientation
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

MAGICS = (b"II*\x00", b"MM\x00*")
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8}
_TYPE_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                      6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
                      34887: "LERC", 34925: "LZMA", 50000: "Zstd", 50001: "WebP"}

(WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIP_OFFSETS,
 ORIENTATION, SPP, ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP,
 TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES, EXTRA, SAMPLE_FORMAT) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320,
    322, 323, 324, 325, 338, 339)


def _ifds(data: bytes) -> Tuple[str, List[Dict[int, tuple]]]:
    """(byte order, the tags of every page in the IFD chain)."""
    if data[:4] not in MAGICS:
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise UnsupportedMediaException("BigTIFF is not ported to the PyTorch package")
        raise ExecFailedException("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    offset = struct.unpack_from(bo + "I", data, 4)[0]
    pages, seen = [], set()
    while offset and offset not in seen and offset + 2 <= len(data):
        seen.add(offset)
        count = struct.unpack_from(bo + "H", data, offset)[0]
        tags: Dict[int, tuple] = {}
        for k in range(count):
            e = offset + 2 + 12 * k
            if e + 12 > len(data):
                break
            tag, typ, n = struct.unpack_from(bo + "HHI", data, e)
            size = _TYPE_SIZES.get(typ)
            if size is None:
                continue
            at = e + 8 if size * n <= 4 else struct.unpack_from(bo + "I", data, e + 8)[0]
            raw = data[at:at + size * n]
            if len(raw) < size * n:
                continue
            if typ in (5, 10):
                vals = struct.unpack(bo + ("I" if typ == 5 else "i") * (2 * n), raw)
                tags[tag] = tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0
                                  for i in range(0, len(vals), 2))
            elif typ in _TYPE_CODES:
                tags[tag] = struct.unpack(bo + _TYPE_CODES[typ] * n, raw)
            else:
                tags[tag] = (raw,)
        pages.append(tags)
        nxt = offset + 2 + 12 * count
        offset = struct.unpack_from(bo + "I", data, nxt)[0] if nxt + 4 <= len(data) else 0
    if not pages:
        raise ExecFailedException("TIFF decode failed: no image file directory")
    return bo, pages


def n_frames(data: bytes) -> int:
    return len(_ifds(data)[1])


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return v[0] if v else default


def _layout(tags) -> Tuple[str, int, int]:
    """Pillow's OPEN_INFO key for the page -> (layout, bits a sample,
    samples a pixel); raises for what the port does not read."""
    photo = _one(tags, PHOTOMETRIC, 0)
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(BPS, (1,))
    extra = tags.get(EXTRA, ())
    spp = _one(tags, SPP, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ExecFailedException("TIFF decode failed: unknown data organization")
    if _one(tags, PLANAR, 1) != 1:
        raise UnsupportedMediaException(
            "planar (separate-plane) TIFF is not ported to the PyTorch package")
    if _one(tags, FILLORDER, 1) != 1:
        raise UnsupportedMediaException(
            "TIFF fill order 2 is not ported to the PyTorch package")
    if fmt != (1,):
        raise UnsupportedMediaException(
            f"TIFF sample format {fmt} is not ported to the PyTorch package")
    b = bps[0]
    if len(set(bps)) != 1:
        raise UnsupportedMediaException(f"TIFF samples of {bps} bits are not ported")
    key = (photo, bps, tuple(extra))
    layouts = {
        (0, (1,), ()): "1;I", (1, (1,), ()): "1",
        (0, (8,), ()): "L;I", (1, (8,), ()): "L",
        (0, (16,), ()): "I;16", (1, (16,), ()): "I;16",
        (1, (8, 8), (2,)): "LA",
        (2, (8, 8, 8), ()): "RGB", (2, (16, 16, 16), ()): "RGB",
        (2, (8,) * 4, ()): "RGBA", (2, (8,) * 4, (0,)): "RGBX",
        (2, (8,) * 4, (1,)): "RGBa", (2, (8,) * 4, (2,)): "RGBA",
        (2, (8,) * 4, (999,)): "RGBA",
        (2, (16,) * 4, ()): "RGBA", (2, (16,) * 4, (0,)): "RGBX",
        (2, (16,) * 4, (1,)): "RGBa", (2, (16,) * 4, (2,)): "RGBA",
        (2, (8,) * 5, (0, 0)): "RGBX", (2, (8,) * 6, (0, 0, 0)): "RGBX",
        (2, (8,) * 5, (1, 0)): "RGBa", (2, (8,) * 6, (1, 0, 0)): "RGBa",
        (2, (8,) * 5, (2, 0)): "RGBA", (2, (8,) * 6, (2, 0, 0)): "RGBA",
        (3, (1,), ()): "P", (3, (2,), ()): "P", (3, (4,), ()): "P", (3, (8,), ()): "P",
        (3, (8, 8), (0,)): "P", (3, (8, 8), (2,)): "PA",
    }
    layout = layouts.get(key)
    if layout is None:
        raise UnsupportedMediaException(
            f"a TIFF of photometric {photo}, {bps} bits and extra samples "
            f"{tuple(extra)} is not ported to the PyTorch package")
    return layout, b, spp


def _decompress(raw: bytes, compression: int, count: int) -> np.ndarray:
    if compression == 1:
        out = np.frombuffer(raw[:count], np.uint8)
    elif compression == 32773:
        out = rasterlib.packbits_decode(raw, count)
    elif compression == 5:
        out, status = rasterlib.tiff_lzw_decode(raw, count)
        if status == 3:
            raise UnsupportedMediaException(
                "old-style TIFF LZW is not ported to the PyTorch package")
    elif compression in (8, 32946):
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(raw, count), np.uint8)
        except zlib.error as exc:
            raise ExecFailedException(f"TIFF Deflate data is damaged: {exc}") from exc
    else:
        name = _COMPRESSION_NAMES.get(compression, str(compression))
        raise UnsupportedMediaException(
            f"TIFF compression {name} is not ported to the PyTorch package")
    if out.size < count:
        raise ExecFailedException("image file is truncated (TIFF strip or tile)")
    return out


def _unpredict(block: np.ndarray, width: int, spp: int, bits: int, bo: str) -> np.ndarray:
    """Horizontal differencing undone on [rows, row bytes]."""
    rows = block.shape[0]
    if bits == 8:
        px = block[:, : width * spp].reshape(rows, width, spp)
        out = block.copy()
        out[:, : width * spp] = np.cumsum(px, axis=1, dtype=np.uint8).reshape(rows, -1)
        return out
    if bits == 16:
        px = block[:, : width * spp * 2].copy().view(bo + "u2").reshape(rows, width, spp)
        summed = np.cumsum(px, axis=1, dtype=np.uint16).astype(bo + "u2")
        out = block.copy()
        out[:, : width * spp * 2] = summed.reshape(rows, -1).view(np.uint8)
        return out
    raise UnsupportedMediaException(
        f"TIFF horizontal differencing of {bits}-bit samples is not ported")


def _page_bytes(data: bytes, tags, bo: str, bits: int, spp: int) -> np.ndarray:
    """The page's samples as [height, row bytes] uint8, strips or tiles
    decompressed and the predictor undone."""
    w, h = _one(tags, WIDTH), _one(tags, LENGTH)
    if not w or not h:
        raise ExecFailedException("TIFF decode failed: missing dimensions")
    compression = _one(tags, COMPRESSION, 1)
    if compression not in _COMPRESSIONS:
        name = _COMPRESSION_NAMES.get(compression, str(compression))
        raise UnsupportedMediaException(
            f"TIFF compression {name} is not ported to the PyTorch package")
    predictor = _one(tags, PREDICTOR, 1)
    if predictor not in (1, 2):
        raise UnsupportedMediaException(f"TIFF predictor {predictor} is not ported")
    row_bytes = (w * spp * bits + 7) // 8
    page = np.zeros((h, row_bytes), np.uint8)
    if TILE_OFFSETS in tags:
        tw, th = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH)
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_BYTES, ())
        tile_row = (tw * spp * bits + 7) // 8
        across = -(-w // tw)
        for k, off in enumerate(offsets):
            ty, tx = divmod(k, across)
            y0, x0 = ty * th, tx * tw
            if y0 >= h:
                break
            raw = data[off:off + (counts[k] if k < len(counts) else len(data))]
            block = _decompress(raw, compression, th * tile_row).reshape(th, tile_row)
            if predictor == 2:
                block = _unpredict(block, tw, spp, bits, bo)
            if bits % 8:
                raise UnsupportedMediaException(
                    f"tiled TIFF of {bits}-bit samples is not ported to the PyTorch package")
            bpp = spp * bits // 8
            cols = min(tw, w - x0)
            page[y0:y0 + th, x0 * bpp:(x0 + cols) * bpp] = \
                block[: min(th, h - y0), : cols * bpp]
        return page
    offsets = tags.get(STRIP_OFFSETS)
    if not offsets:
        raise ExecFailedException("TIFF decode failed: no strips or tiles")
    counts = tags.get(STRIP_BYTES, ())
    per = min(_one(tags, ROWS_PER_STRIP, h), h) or h
    for k, off in enumerate(offsets):
        y0 = k * per
        if y0 >= h:
            break
        rows = min(per, h - y0)
        raw = data[off:off + (counts[k] if k < len(counts) else len(data))]
        block = _decompress(raw, compression, rows * row_bytes).reshape(rows, row_bytes)
        if predictor == 2:
            block = _unpredict(block, w, spp, bits, bo)
        page[y0:y0 + rows] = block
    return page


def _unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpack: c * 255 / a, truncated and clipped."""
    a = alpha.astype(np.int32)[..., None]
    out = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
    out = np.where(a == 255, rgb, out)
    return np.where(a == 0, 0, out).astype(np.uint8)


def _pixels(page: np.ndarray, tags, layout: str, bits: int, spp: int, bo: str):
    w, h = _one(tags, WIDTH), _one(tags, LENGTH)
    if bits < 8:
        unpacked = np.unpackbits(page, axis=1)[:, : w * bits].reshape(h, w, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        samples = (unpacked * weights).sum(axis=2).astype(np.uint8)[..., None]
    elif bits == 8:
        samples = page[:, : w * spp].reshape(h, w, spp)
    else:
        wide = page[:, : w * spp * 2].copy().view(bo + "u2").reshape(h, w, spp)
        if layout == "I;16":
            samples = np.minimum(wide, 255).astype(np.uint8)
        else:
            samples = (wide >> 8).astype(np.uint8)
    if layout in ("1", "1;I"):
        on = samples[..., 0] != 0
        gray = np.where(on ^ (layout == "1;I"), 255, 0).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2), None
    if layout in ("L", "L;I", "I;16"):
        gray = samples[..., 0] if layout != "L;I" else 255 - samples[..., 0]
        return np.repeat(gray[..., None], 3, axis=2), None
    if layout == "LA":
        return np.repeat(samples[..., :1], 3, axis=2), np.ascontiguousarray(samples[..., 1])
    if layout in ("P", "PA"):
        cmap = tags.get(COLORMAP)
        if not cmap:
            raise ExecFailedException("TIFF decode failed: a palette page has no colour map")
        n = len(cmap) // 3
        table = np.zeros((256, 3), np.uint8)
        planes = (np.asarray(cmap[: 3 * n], np.int64) // 256).astype(np.uint8).reshape(3, n).T
        table[: min(n, 256)] = planes[:256]
        rgb = table[samples[..., 0]]
        return rgb, np.ascontiguousarray(samples[..., 1]) if layout == "PA" else None
    rgb = np.ascontiguousarray(samples[..., :3])
    if layout == "RGB" or layout == "RGBX":
        return rgb, None
    alpha = np.ascontiguousarray(samples[..., 3])
    if layout == "RGBa":
        rgb = _unpremultiply(rgb, alpha)
    return rgb, alpha


def decode(data: bytes, frame: int = 0) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """TIFF bytes -> (rgb, alpha or None, n_frames) of page
    ``min(frame, n_frames - 1)``, upright."""
    bo, pages = _ifds(data)
    total = len(pages)
    tags = pages[min(max(int(frame), 0), total - 1) if total > 1 else 0]
    layout, bits, spp = _layout(tags)
    page = _page_bytes(data, tags, bo, bits, spp)
    rgb, alpha = _pixels(page, tags, layout, bits, spp, bo)
    orientation = _one(tags, ORIENTATION, 1)
    if orientation in range(2, 9):
        rgb = np.ascontiguousarray(apply_orientation(rgb, orientation))
        if alpha is not None:
            alpha = np.ascontiguousarray(apply_orientation(alpha, orientation))
    return np.ascontiguousarray(rgb), alpha, total
