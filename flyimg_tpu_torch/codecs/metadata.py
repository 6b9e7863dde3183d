"""Container walks for EXIF orientation in PNG and WebP sources.

The port's copy of the orientation part of ``flyimg_tpu/codecs/metadata.py``
(``png_orientation``, ``webp_orientation`` and the chunk walks under them).
ImageMagick's ``-auto-orient`` honours orientation in any container, and
neither the PNG nor the WebP decoder applies it, so decode reads it here.
Metadata grafting (``st_0``) is not ported yet.
"""

from __future__ import annotations

import struct

from flyimg_tpu_torch.codecs.exif import SCAN_LIMIT, tiff_orientation

_EXIF_HEADER = b"Exif\x00\x00"
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunks(data: bytes):
    """Yield (type, data_offset, data_len) for PNG chunks."""
    if not data.startswith(_PNG_SIG):
        return
    i = len(_PNG_SIG)
    n = min(len(data), SCAN_LIMIT)
    while i + 8 <= n:
        (clen,) = struct.unpack(">I", data[i : i + 4])
        ctype = data[i + 4 : i + 8]
        if i + 12 + clen > n:
            return
        yield ctype, i + 8, clen
        if ctype == b"IEND":
            return
        i += 12 + clen


def png_orientation(data: bytes) -> int:
    """EXIF orientation of a PNG's eXIf chunk (1 when absent)."""
    try:
        for ctype, off, clen in _png_chunks(data):
            if ctype == b"eXIf":
                return tiff_orientation(data[off : off + clen])
    except (struct.error, IndexError):
        return 1
    return 1


def _webp_chunks(data: bytes):
    """Yield (fourcc, payload_offset, payload_len) for RIFF/WEBP chunks."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return
    i = 12
    n = min(len(data), SCAN_LIMIT)
    while i + 8 <= n:
        fourcc = data[i : i + 4]
        (clen,) = struct.unpack("<I", data[i + 4 : i + 8])
        if i + 8 + clen > n:
            return
        yield fourcc, i + 8, clen
        i += 8 + clen + (clen & 1)  # chunks are 2-byte aligned


def webp_orientation(data: bytes) -> int:
    """EXIF orientation of a WebP's EXIF chunk (1 when absent). The spec
    says raw TIFF, but many writers keep the JPEG-style Exif\\0\\0 prefix:
    both are read."""
    try:
        for fourcc, off, clen in _webp_chunks(data):
            if fourcc == b"EXIF":
                chunk = data[off : off + clen]
                if chunk.startswith(_EXIF_HEADER):
                    chunk = chunk[len(_EXIF_HEADER) :]
                return tiff_orientation(chunk)
    except (struct.error, IndexError):
        return 1
    return 1
