"""Source metadata for ``st_0`` answers, and EXIF orientation of PNG and
WebP sources.

The port's copy of ``flyimg_tpu/codecs/metadata.py``. The reference omits
``-strip`` unless ``st_1``, so ImageMagick keeps the source's EXIF, ICC
profile and XMP in every output. Decoding to raw pixels loses those bytes,
so ``collect`` reads them from the source container and ``inject`` grafts
them into the encoded answer:

- JPEG in: APP1 Exif (orientation reset to 1), APP2 ICC_PROFILE chunks
  (reassembled across segments), APP1 XMP.
- PNG in: iCCP (inflated) and eXIf.
- WebP in: the ICCP, EXIF and XMP chunks of the extended (VP8X) container.
- JPEG out: APP1 Exif + APP1 XMP + the APP2 ICC train (<= 65519 bytes a
  chunk) after SOI and any APP0 (right after SOI when the encoder wrote
  no APP0).
- PNG out: iCCP (deflated) and eXIf right after IHDR (iCCP must precede
  PLTE and IDAT, PNG 1.2 section 4.2).
- WebP out: the container rebuilt as VP8X with ICCP before the image
  chunks and EXIF, XMP after them; ICCP/EXIF/XMP chunks already there are
  replaced, the alpha and animation bits kept.

ImageMagick's ``-auto-orient`` honours orientation in any container and
neither the PNG nor the WebP decoder applies it, so decode reads it here
(``png_orientation``, ``webp_orientation``).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

from flyimg_tpu_torch.codecs.exif import (
    SCAN_LIMIT,
    reset_tiff_orientation,
    tiff_orientation,
)

_EXIF_HEADER = b"Exif\x00\x00"

_ICC_HEADER = b"ICC_PROFILE\x00"
_XMP_HEADER = b"http://ns.adobe.com/xap/1.0/\x00"
# max ICC payload bytes per APP2: 65535 (seg len field ceiling) - 2 (the
# length field counts itself) - 12 (ICC_PROFILE\0) - 2 (seq/count bytes)
_ICC_CHUNK = 65519
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


@dataclass
class SourceMetadata:
    """What survives a transform when -strip is off. EXIF is held as the
    raw TIFF stream (orientation already reset) — container framing is an
    INJECT-time concern: JPEG wraps it in an APP1 (64KB cap applies only
    there), PNG writes it verbatim into eXIf (2^31 chunk limit)."""

    exif_tiff: Optional[bytes] = None  # raw TIFF stream, orientation reset
    icc: Optional[bytes] = None        # raw ICC profile bytes
    xmp: Optional[bytes] = None        # raw XMP packet (no namespace header)

    def __bool__(self) -> bool:
        return any((self.exif_tiff, self.icc, self.xmp))


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------


def _jpeg_segments(data: bytes):
    """Yield (marker, payload_offset, payload_len) for leading JPEG
    segments, stopping at SOS (metadata lives before entropy data)."""
    i = 2
    n = min(len(data), SCAN_LIMIT)
    while i + 4 <= n:
        if data[i] != 0xFF:
            return
        marker = data[i + 1]
        if marker == 0xD8:
            i += 2
            continue
        if marker in (0xDA, 0xD9):
            return
        seglen = struct.unpack(">H", data[i + 2 : i + 4])[0]
        if seglen < 2 or i + 2 + seglen > n:
            return
        yield marker, i + 4, seglen - 2
        i += 2 + seglen


def collect_jpeg(data: bytes) -> SourceMetadata:
    """ONE marker walk collects Exif, ICC, and XMP together (_jpeg_segments
    already rejects segments whose declared length runs past EOF, so every
    payload seen here is complete)."""
    meta = SourceMetadata()
    icc_parts: List[tuple] = []
    try:
        for marker, off, plen in _jpeg_segments(data):
            payload = data[off : off + plen]
            if marker == 0xE2 and payload.startswith(_ICC_HEADER):
                # seq is 1-based; a profile may span many APP2 segments
                seq = payload[len(_ICC_HEADER)]
                icc_parts.append((seq, payload[len(_ICC_HEADER) + 2 :]))
            elif marker == 0xE1 and payload.startswith(_EXIF_HEADER):
                if meta.exif_tiff is None:
                    meta.exif_tiff = reset_tiff_orientation(
                        payload[len(_EXIF_HEADER) :]
                    )
            elif (
                marker == 0xE1
                and payload.startswith(_XMP_HEADER)
                and meta.xmp is None
            ):
                meta.xmp = payload[len(_XMP_HEADER) :]
    except (struct.error, IndexError):
        return meta
    if icc_parts:
        icc_parts.sort(key=lambda part: part[0])
        meta.icc = b"".join(part[1] for part in icc_parts)
    return meta


def png_orientation(data: bytes) -> int:
    """EXIF orientation of a PNG's eXIf chunk (1 when absent). IM's
    -auto-orient honors orientation in ANY container, so the decode path
    must apply it for PNG sources too, not just JPEG APP1."""
    try:
        for ctype, off, clen in _png_chunks(data):
            if ctype == b"eXIf":
                return tiff_orientation(data[off : off + clen])
    except (struct.error, IndexError):
        return 1
    return 1


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


def collect_png(data: bytes) -> SourceMetadata:
    meta = SourceMetadata()
    try:
        for ctype, off, clen in _png_chunks(data):
            chunk = data[off : off + clen]
            if ctype == b"iCCP" and meta.icc is None:
                # profile-name\0 compression-method(0) deflate-stream
                zero = chunk.find(b"\x00")
                if zero < 0 or zero + 2 > len(chunk) or chunk[zero + 1] != 0:
                    continue
                try:
                    meta.icc = zlib.decompress(chunk[zero + 2 :])
                except zlib.error:
                    continue
            elif ctype == b"eXIf" and meta.exif_tiff is None:
                # eXIf carries the raw TIFF stream directly. Orientation
                # resets to 1 like the JPEG path — decode applied it to
                # the pixels (png_orientation above). No size cap here:
                # PNG chunks allow 2^31 bytes; the APP1 64KB ceiling only
                # matters when the OUTPUT is JPEG (inject_jpeg).
                meta.exif_tiff = reset_tiff_orientation(chunk)
    except (struct.error, IndexError):
        return meta
    return meta


def _webp_chunks(data: bytes, limit: Optional[int] = None):
    """Yield (fourcc, payload_offset, payload_len) for RIFF/WEBP chunks.
    ``limit`` defaults to the untrusted-source scan budget; the inject
    path passes len(data) — it walks the pipeline's OWN encoded output,
    and stopping early there would silently drop the image chunk."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return
    i = 12
    n = min(len(data), SCAN_LIMIT if limit is None else limit)
    while i + 8 <= n:
        fourcc = data[i : i + 4]
        (clen,) = struct.unpack("<I", data[i + 4 : i + 8])
        if i + 8 + clen > n:
            return
        yield fourcc, i + 8, clen
        i += 8 + clen + (clen & 1)  # chunks are 2-byte aligned


def collect_webp(data: bytes) -> SourceMetadata:
    meta = SourceMetadata()
    try:
        for fourcc, off, clen in _webp_chunks(data):
            chunk = data[off : off + clen]
            if fourcc == b"ICCP" and meta.icc is None:
                meta.icc = chunk
            elif fourcc == b"EXIF" and meta.exif_tiff is None:
                # the spec says raw TIFF, but many writers include the
                # JPEG-style Exif\0\0 prefix — accept both
                tiff = (
                    chunk[len(_EXIF_HEADER) :]
                    if chunk.startswith(_EXIF_HEADER)
                    else chunk
                )
                meta.exif_tiff = reset_tiff_orientation(tiff)
            elif fourcc == b"XMP " and meta.xmp is None:
                meta.xmp = chunk
    except (struct.error, IndexError):
        return meta
    return meta


def webp_orientation(data: bytes) -> int:
    """EXIF orientation of a WebP's EXIF chunk (1 when absent) — IM's
    -auto-orient honors it; libwebp decode does not."""
    try:
        for fourcc, off, clen in _webp_chunks(data):
            if fourcc == b"EXIF":
                chunk = data[off : off + clen]
                tiff = (
                    chunk[len(_EXIF_HEADER) :]
                    if chunk.startswith(_EXIF_HEADER)
                    else chunk
                )
                return tiff_orientation(tiff)
    except (struct.error, IndexError):
        return 1
    return 1


def collect(data: bytes, mime: str) -> SourceMetadata:
    """Source bytes -> whatever metadata the container carries."""
    if mime == "image/jpeg":
        return collect_jpeg(data)
    if mime == "image/png":
        return collect_png(data)
    if mime == "image/webp":
        return collect_webp(data)
    return SourceMetadata()


# ---------------------------------------------------------------------------
# injection
# ---------------------------------------------------------------------------


def _icc_app2_train(icc: bytes) -> bytes:
    """Split a profile into the standard APP2 ICC_PROFILE chunk train."""
    chunks = [icc[i : i + _ICC_CHUNK] for i in range(0, len(icc), _ICC_CHUNK)]
    count = len(chunks)
    if count > 255:
        return b""  # profile too large for the JPEG chunk scheme
    out = []
    for seq, chunk in enumerate(chunks, start=1):
        payload = _ICC_HEADER + bytes((seq, count)) + chunk
        out.append(b"\xff\xe2" + struct.pack(">H", 2 + len(payload)) + payload)
    return b"".join(out)


def inject_jpeg(jpeg: bytes, meta: SourceMetadata) -> bytes:
    """Insert carried metadata after SOI/APP0 (the canonical slot)."""
    if jpeg[:2] != b"\xff\xd8" or not meta:
        return jpeg
    segments = []
    if meta.exif_tiff is not None:
        payload = _EXIF_HEADER + meta.exif_tiff
        if 2 + len(payload) <= 0xFFFF:  # APP1 length-field ceiling
            segments.append(
                b"\xff\xe1" + struct.pack(">H", 2 + len(payload)) + payload
            )
    if meta.xmp is not None:
        payload = _XMP_HEADER + meta.xmp
        if 2 + len(payload) <= 0xFFFF:
            segments.append(
                b"\xff\xe1" + struct.pack(">H", 2 + len(payload)) + payload
            )
    if meta.icc is not None:
        segments.append(_icc_app2_train(meta.icc))
    blob = b"".join(segments)
    if not blob:
        return jpeg
    pos = 2
    while (
        pos + 4 <= len(jpeg) and jpeg[pos] == 0xFF and jpeg[pos + 1] == 0xE0
    ):
        (seglen,) = struct.unpack(">H", jpeg[pos + 2 : pos + 4])
        pos += 2 + seglen
    return jpeg[:pos] + blob + jpeg[pos:]


def _png_chunk(ctype: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)


def inject_png(png: bytes, meta: SourceMetadata) -> bytes:
    """Insert iCCP/eXIf right after IHDR (iCCP must precede PLTE/IDAT)."""
    if not png.startswith(_PNG_SIG) or not meta:
        return png
    chunks = []
    if meta.icc is not None:
        chunks.append(
            _png_chunk(b"iCCP", b"ICC Profile\x00\x00" + zlib.compress(meta.icc))
        )
    if meta.exif_tiff is not None:
        chunks.append(_png_chunk(b"eXIf", meta.exif_tiff))
    blob = b"".join(chunks)
    if not blob:
        return png
    # IHDR is always first: signature + len(4) type(4) data(13) crc(4)
    pos = len(_PNG_SIG) + 8 + 13 + 4
    if len(png) < pos:
        return png
    return png[:pos] + blob + png[pos:]


def _webp_canvas_dims(data: bytes):
    """(width, height) parsed from the image chunk of a simple WebP, or
    None. VP8: 14-bit dims after the 0x9d012a start code; VP8L: 14-bit
    minus-one dims packed after the 0x2f signature."""
    for fourcc, off, clen in _webp_chunks(data, limit=len(data)):
        chunk = data[off : off + clen]
        if fourcc == b"VP8 " and clen >= 10:
            if chunk[3:6] != b"\x9d\x01\x2a":
                return None
            (w,) = struct.unpack("<H", chunk[6:8])
            (h,) = struct.unpack("<H", chunk[8:10])
            return w & 0x3FFF, h & 0x3FFF
        if fourcc == b"VP8L" and clen >= 5:
            if chunk[0] != 0x2F:
                return None
            (bits,) = struct.unpack("<I", chunk[1:5])
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        if fourcc == b"VP8X" and clen >= 10:
            w = int.from_bytes(chunk[4:7], "little") + 1
            h = int.from_bytes(chunk[7:10], "little") + 1
            return w, h
    return None


def _webp_chunk(fourcc: bytes, payload: bytes) -> bytes:
    out = fourcc + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        out += b"\x00"  # RIFF chunks are 2-byte aligned
    return out


def inject_webp(webp: bytes, meta: SourceMetadata) -> bytes:
    """Rebuild the container as extended (VP8X) with metadata chunks in
    spec order: VP8X, ICCP, image data, EXIF, XMP. Existing
    ICCP/EXIF/XMP chunks (possible when libwebp already emitted VP8X for
    an alpha image) are replaced by the carried ones."""
    if webp[:4] != b"RIFF" or webp[8:12] != b"WEBP" or not meta:
        return webp
    dims = _webp_canvas_dims(webp)
    if dims is None:
        return webp
    w, h = dims
    if not (1 <= w <= 1 << 14 and 1 <= h <= 1 << 14):
        return webp

    image_chunks = []
    flags = 0
    for fourcc, off, clen in _webp_chunks(webp, limit=len(webp)):
        chunk = webp[off : off + clen]
        if fourcc == b"VP8X":
            # keep the original's alpha/animation bits (ANIM/ANMF chunks
            # pass through below); ICC/EXIF/XMP bits are rebuilt
            if clen >= 1:
                flags |= chunk[0] & 0x12
            continue
        if fourcc in (b"ICCP", b"EXIF", b"XMP "):
            continue  # rebuilt below
        if fourcc == b"ALPH":
            flags |= 0x10
        if fourcc == b"VP8L" and clen >= 5 and chunk[0] == 0x2F:
            # lossless carries alpha inside the bitstream: bit 28 of the
            # header word is alpha_is_used (the container's alpha flag
            # must agree or strict muxers reject the file)
            (bits,) = struct.unpack("<I", chunk[1:5])
            if (bits >> 28) & 1:
                flags |= 0x10
        image_chunks.append(_webp_chunk(fourcc, chunk))

    parts = []
    if meta.icc is not None:
        flags |= 0x20
        parts.append(_webp_chunk(b"ICCP", meta.icc))
    parts.extend(image_chunks)
    if meta.exif_tiff is not None:
        flags |= 0x08
        parts.append(_webp_chunk(b"EXIF", meta.exif_tiff))
    if meta.xmp is not None:
        flags |= 0x04
        parts.append(_webp_chunk(b"XMP ", meta.xmp))
    vp8x = _webp_chunk(
        b"VP8X",
        bytes((flags, 0, 0, 0))
        + (w - 1).to_bytes(3, "little")
        + (h - 1).to_bytes(3, "little"),
    )
    body = b"WEBP" + vp8x + b"".join(parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def inject(content: bytes, extension: str, meta: SourceMetadata) -> bytes:
    if extension == "jpg":
        return inject_jpeg(content, meta)
    if extension == "png":
        return inject_png(content, meta)
    if extension == "webp":
        return inject_webp(content, meta)
    return content
