"""Header-sniffing media probe: MIME type + dimensions without a full decode.

The native-probe equivalent of the reference's ``identify`` +
``finfo_file`` usage (reference src/Core/Entity/ImageMetaInfo.php:51-63,
143-166): pure byte parsing of JPEG/PNG/GIF/WebP/BMP/PDF/MP4-family headers.
Used for content negotiation (o_auto/o_input), the video/PDF ingestion
gates, and the rf_1 debug headers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

JPEG_MIME = "image/jpeg"
PNG_MIME = "image/png"
GIF_MIME = "image/gif"
WEBP_MIME = "image/webp"
BMP_MIME = "image/bmp"
PDF_MIME = "application/pdf"
MP4_MIME = "video/mp4"
WEBM_MIME = "video/webm"
AVI_MIME = "video/x-msvideo"
MOV_MIME = "video/quicktime"


@dataclass(frozen=True)
class MediaInfo:
    mime: str
    width: Optional[int] = None
    height: Optional[int] = None

    @property
    def is_image(self) -> bool:
        return self.mime.startswith("image/")

    @property
    def is_video(self) -> bool:
        return self.mime.startswith("video/")

    @property
    def is_pdf(self) -> bool:
        return self.mime == PDF_MIME


def _jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """Walk JPEG markers to the SOFn frame header."""
    i = 2
    n = len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:  # legal fill byte before a marker
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if i + 4 > n:
            return None
        seglen = struct.unpack(">H", data[i + 2 : i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 <= n:
                h, w = struct.unpack(">HH", data[i + 5 : i + 9])
                return (w, h)
            return None
        i += 2 + seglen
    return None


def _webp_dims(data: bytes) -> Optional[Tuple[int, int]]:
    if len(data) < 30:
        return None
    fourcc = data[12:16]
    if fourcc == b"VP8 ":  # lossy: 14-bit dims at frame start
        w, h = struct.unpack("<HH", data[26:30])
        return (w & 0x3FFF, h & 0x3FFF)
    if fourcc == b"VP8L":  # lossless: packed 14-bit dims
        bits = struct.unpack("<I", data[21:25])[0]
        return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1)
    if fourcc == b"VP8X":  # extended: 24-bit canvas dims minus one
        w = int.from_bytes(data[24:27], "little") + 1
        h = int.from_bytes(data[27:30], "little") + 1
        return (w, h)
    return None


def sniff(data: bytes) -> MediaInfo:
    """Identify media type + dims from leading bytes (>= 64 recommended)."""
    if len(data) < 12:
        return MediaInfo("application/octet-stream")

    if data[:3] == b"\xff\xd8\xff":
        dims = _jpeg_dims(data)
        return MediaInfo(JPEG_MIME, *(dims or (None, None)))
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        w, h = struct.unpack(">II", data[16:24]) if len(data) >= 24 else (None, None)
        return MediaInfo(PNG_MIME, w, h)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        w, h = struct.unpack("<HH", data[6:10])
        return MediaInfo(GIF_MIME, w, h)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        dims = _webp_dims(data)
        return MediaInfo(WEBP_MIME, *(dims or (None, None)))
    if data[:2] == b"BM":
        if len(data) >= 26:
            w, h = struct.unpack("<ii", data[18:26])
            return MediaInfo(BMP_MIME, w, abs(h))
        return MediaInfo(BMP_MIME)
    if data[:5] == b"%PDF-":
        return MediaInfo(PDF_MIME)
    if data[4:8] == b"ftyp":
        brand = data[8:12]
        if brand in (b"qt  ",):
            return MediaInfo(MOV_MIME)
        return MediaInfo(MP4_MIME)
    if data[:4] == b"\x1a\x45\xdf\xa3":
        return MediaInfo(WEBM_MIME)
    if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
        return MediaInfo(AVI_MIME)
    return MediaInfo("application/octet-stream")
