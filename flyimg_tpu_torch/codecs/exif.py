"""EXIF orientation: read it from a TIFF stream or a JPEG's APP1, reset it,
apply it to pixels.

The port's copy of ``flyimg_tpu/codecs/exif.py``.
The reference always asks for ``-auto-orient``, so every decode path turns
the pixels upright: orientation is parsed from IFD0's tag 0x0112 and
applied as numpy flips and transposes (exact, copy-light). PNG eXIf and
WebP EXIF chunks (codecs/metadata.py) go through the same TIFF parser, so
the containers cannot disagree.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

#: scan budget for untrusted container walks (JPEG markers, PNG and WebP
#: chunks)
SCAN_LIMIT = 4 * 1024 * 1024


def _tiff_orientation_entry(tiff: bytes) -> Optional[Tuple[int, str]]:
    """(value_offset, endian) of IFD0's 0x0112 value field in a raw TIFF
    stream. Every offset is attacker-controlled, so the entry is returned
    only when its full 12 bytes lie inside the stream; None otherwise.
    Callers slice ``tiff`` to its containing segment first, which makes
    this single bounds check cover both the buffer and the segment."""
    try:
        if tiff[:2] == b"II":
            endian = "<"
        elif tiff[:2] == b"MM":
            endian = ">"
        else:
            return None
        (ifd_off,) = struct.unpack(endian + "I", tiff[4:8])
        (count,) = struct.unpack(endian + "H", tiff[ifd_off : ifd_off + 2])
        for k in range(count):
            entry = ifd_off + 2 + 12 * k
            if entry + 12 > len(tiff):
                return None
            (tag,) = struct.unpack(endian + "H", tiff[entry : entry + 2])
            if tag == 0x0112:
                return entry + 8, endian
        return None
    except (struct.error, IndexError):
        return None


def tiff_orientation(tiff: bytes) -> int:
    """EXIF orientation 1..8 from a raw TIFF stream; 1 on any failure."""
    found = _tiff_orientation_entry(tiff)
    if found is None:
        return 1
    off, endian = found
    (value,) = struct.unpack(endian + "H", tiff[off : off + 2])
    return value if 1 <= value <= 8 else 1


def reset_tiff_orientation(tiff: bytes) -> bytes:
    """``tiff`` with IFD0's orientation set to 1 (the pixels are already
    upright, so metadata carried into an answer must not rotate them
    again); unchanged when it has no orientation entry."""
    found = _tiff_orientation_entry(tiff)
    if found is None:
        return tiff
    off, endian = found
    out = bytearray(tiff)
    out[off : off + 2] = struct.pack(endian + "H", 1)
    return bytes(out)


def _find_exif_app1(data: bytes) -> Optional[Tuple[int, int]]:
    """(segment_offset, declared_segment_length) of the first EXIF APP1 in
    a JPEG, or None. Marker walk only: the TIFF is parsed from the
    segment-bounded slice."""
    try:
        i = 2
        n = min(len(data), SCAN_LIMIT)
        while i + 4 < n:
            if data[i] != 0xFF:
                return None
            marker = data[i + 1]
            if marker == 0xD8:
                i += 2
                continue
            if marker in (0xDA, 0xD9):  # start of scan / end
                return None
            seglen = struct.unpack(">H", data[i + 2 : i + 4])[0]
            if marker == 0xE1 and data[i + 4 : i + 10] == b"Exif\x00\x00":
                return i, seglen
            i += 2 + seglen
        return None
    except (struct.error, IndexError):
        return None


def jpeg_orientation(data: bytes) -> int:
    """EXIF orientation 1..8 (1 = upright) from JPEG bytes; 1 on any parse
    failure. The TIFF stream is sliced to its APP1 segment (never past it,
    never past the end of the data)."""
    found = _find_exif_app1(data)
    if found is None:
        return 1
    i, seglen = found
    return tiff_orientation(data[i + 10 : min(i + 2 + seglen, len(data))])


def apply_orientation(pixels: np.ndarray, orientation: int) -> np.ndarray:
    """Apply EXIF orientation 1..8 to [h, w] or [h, w, c] (the transform
    set of PIL's ``exif_transpose``)."""
    if orientation == 2:
        return np.flip(pixels, axis=1)
    if orientation == 3:
        return np.flip(pixels, axis=(0, 1))
    if orientation == 4:
        return np.flip(pixels, axis=0)
    if orientation == 5:
        return np.swapaxes(pixels, 0, 1)
    if orientation == 6:
        return np.flip(np.swapaxes(pixels, 0, 1), axis=1)
    if orientation == 7:
        return np.flip(np.swapaxes(pixels, 0, 1), axis=(0, 1))
    if orientation == 8:
        return np.flip(np.swapaxes(pixels, 0, 1), axis=0)
    return pixels
