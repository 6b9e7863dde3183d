"""Writers of hand-built GIF, animated WebP, BMP, ICO and TIFF files for the
CPU tests of the port's raster codecs (and ``tools/make_format_fixtures.py``).

Each writer sets the container's fields itself, so a test reaches layouts
Pillow's own writers never produce (a disposal method per frame, partial
frames, local colour tables, interlace, RLE, bitfields, tiles, both byte
orders, predictors). The compressed data comes from plain encoders here
(GIF and TIFF LZW, PackBits) or zlib; the WebP frames' bitstreams come from
Pillow's still encodes. Nothing here is part of the package.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------- GIF


def gif_lzw(indices: Sequence[int], min_code: int) -> bytes:
    """Plain GIF LZW (clear first and when the table is full), in
    sub-blocks, after the code size byte."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    out, acc, nacc = bytearray(), 0, 0
    width = min_code + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table, nxt = {}, eoi + 1
    put(clear)
    seq = [int(v) for v in indices]
    cur = seq[0]
    for b in seq[1:]:
        if (cur, b) in table:
            cur = table[(cur, b)]
            continue
        put(cur)
        if nxt < 4096:
            table[(cur, b)] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear)
            table, width, nxt = {}, min_code + 1, eoi + 1
        cur = b
    put(cur)
    if nxt < 4096:
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
    put(eoi)
    if nacc:
        out.append(acc & 255)
    blocks = bytearray([min_code])
    for i in range(0, len(out), 255):
        blocks.append(len(out[i:i + 255]))
        blocks += out[i:i + 255]
    blocks.append(0)
    return bytes(blocks)


def _table_field(n: int) -> int:
    bits = 1
    while (1 << bits) < n:
        bits += 1
    return bits


def gif(size, frames: List[dict], global_palette=None, background=0,
        loop: Optional[int] = None) -> bytes:
    """A GIF89a of ``frames``: dicts with ``idx`` ([h, w] indices) and
    optionally ``offset``, ``local`` (a colour table), ``transparency``,
    ``disposal``, ``delay`` (centiseconds), ``interlace``, ``gce`` (False:
    no graphic control block) and ``code_size``."""
    w, h = size
    out = bytearray(b"GIF89a" + struct.pack("<HH", w, h))
    if global_palette is not None:
        bits = _table_field(len(global_palette))
        pal = np.zeros((1 << bits, 3), np.uint8)
        pal[:len(global_palette)] = global_palette
        out += bytes([128 | (bits - 1), background, 0]) + pal.tobytes()
    else:
        out += bytes([0, background, 0])
    if loop is not None:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        fh, fw = idx.shape
        if f.get("gce", True):
            t = f.get("transparency")
            packed = (f.get("disposal", 0) << 2) | (1 if t is not None else 0)
            out += b"!\xf9\x04" + bytes([packed]) + struct.pack("<H", f.get("delay", 5)) \
                + bytes([t or 0, 0])
        x0, y0 = f.get("offset", (0, 0))
        flags = 64 if f.get("interlace") else 0
        table = b""
        if f.get("local") is not None:
            bits = _table_field(len(f["local"]))
            pal = np.zeros((1 << bits, 3), np.uint8)
            pal[:len(f["local"])] = f["local"]
            flags |= 128 | (bits - 1)
            table = pal.tobytes()
        out += b"," + struct.pack("<HHHH", x0, y0, fw, fh) + bytes([flags]) + table
        rows = idx
        if f.get("interlace"):
            rows = idx[np.concatenate([np.arange(s, fh, st)
                                       for s, st in ((0, 8), (4, 8), (2, 4), (1, 2))])]
        out += gif_lzw(rows.reshape(-1), f.get("code_size", 8))
    return bytes(out + b";")


# ---------------------------------------------------------------- WebP


def _riff_chunks(data: bytes):
    pos = 12
    while pos + 8 <= len(data):
        fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        yield fourcc, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def webp_frame(pixels: np.ndarray, *, lossless: bool, quality: int = 80) -> bytes:
    """A frame's ANMF payload (ALPH and VP8, or VP8L) from Pillow's still
    encode of ``pixels`` ([h, w, 3|4])."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "WEBP", lossless=lossless, quality=quality)
    return b"".join(_chunk(c, b) for c, b in _riff_chunks(buf.getvalue())
                    if c in (b"ALPH", b"VP8 ", b"VP8L"))


def webp_animation(size, frames: List[dict], *, alpha: bool, loop: int = 0,
                   background=(255, 255, 255, 255)) -> bytes:
    """An animated WebP: ``frames`` are dicts with ``payload``
    (``webp_frame``), ``offset`` (even), ``size``, ``duration``, ``blend``
    (default True) and ``dispose`` (True: to the background)."""
    w, h = size
    vp8x = bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0]) \
        + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    b, g, r, a = background[2], background[1], background[0], background[3]
    body = _chunk(b"VP8X", vp8x) + _chunk(b"ANIM", bytes([b, g, r, a]) + struct.pack("<H", loop))
    for f in frames:
        x, y = f.get("offset", (0, 0))
        fw, fh = f["size"]
        flags = (0 if f.get("blend", True) else 0x02) | (0x01 if f.get("dispose") else 0)
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") \
            + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little") \
            + f.get("duration", 50).to_bytes(3, "little") + bytes([flags])
        body += _chunk(b"ANMF", head + f["payload"])
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---------------------------------------------------------------- BMP


def _pack_rows(idx: np.ndarray, bits: int) -> np.ndarray:
    h, w = idx.shape
    if bits == 8:
        rows = idx.astype(np.uint8)
    else:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = idx
        groups = padded.reshape(h, -1, per).astype(np.uint16)
        shifts = np.arange(per - 1, -1, -1) * bits
        rows = (groups << shifts).sum(axis=2).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out


def _rle(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8/RLE4 rows (bottom-up order given by the caller): runs of equal
    values as encoded pairs, other stretches as absolute runs."""
    out = bytearray()
    for row in idx:
        row = [int(v) for v in row]
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 3 or j == len(row):
                out += bytes([j - i, (row[i] << 4 | row[i]) if rle4 else row[i]])
                i = j
                continue
            k = i
            while k < len(row) and k - i < 254 and not (
                    k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            n = k - i
            if n < 3:
                out += bytes([1, (row[i] << 4 | row[i]) if rle4 else row[i]])
                i += 1
                continue
            if rle4:
                n -= n % 2
                vals = row[i:i + n]
                data = bytes((vals[m] << 4) | vals[m + 1] for m in range(0, n, 2))
            else:
                data = bytes(row[i:i + n])
            out += bytes([0, n]) + data + (b"\0" if len(data) % 2 else b"")
            i += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp(pixels: np.ndarray, *, bits: int, palette=None, header: int = 40,
        top_down: bool = False, compression: int = 0, masks=None,
        layout: str = "BGRX", colors: int = 0) -> bytes:
    """A BMP of ``pixels``: indices [h, w] for 1-8 bits (with ``palette``
    [n, 3] RGB), [h, w] 16-bit words for 16 bits, [h, w, 3|4] for 24/32
    bits written in ``layout`` byte order. ``compression`` 1/2 writes
    RLE8/RLE4, 3 bitfields (``masks``)."""
    h, w = pixels.shape[:2]
    rows_in_file = pixels if top_down else pixels[::-1]
    if compression in (1, 2):
        body = _rle(np.asarray(rows_in_file), compression == 2)
    elif bits <= 8:
        body = _pack_rows(np.asarray(rows_in_file), bits).tobytes()
    elif bits == 16:
        stride = ((w * 16 + 31) >> 3) & ~3
        out = np.zeros((h, stride), np.uint8)
        out[:, : 2 * w] = np.asarray(rows_in_file, "<u2").view(np.uint8).reshape(h, 2 * w)
        body = out.tobytes()
    else:
        nb = bits // 8
        chan = {"R": 0, "G": 1, "B": 2, "A": 3}
        src = np.asarray(rows_in_file)
        px = np.zeros((h, w, nb), np.uint8)
        for k, c in enumerate(layout[:nb]):
            if c in chan and chan[c] < src.shape[2]:
                px[..., k] = src[..., chan[c]]
        stride = ((w * bits + 31) >> 3) & ~3
        out = np.zeros((h, stride), np.uint8)
        out[:, : w * nb] = px.reshape(h, -1)
        body = out.tobytes()
    pal = b""
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:, ::-1]
        if header == 12:
            pal = entries.tobytes()
        else:
            pal = np.concatenate([entries, np.zeros((len(entries), 1), np.uint8)], 1).tobytes()
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                          compression, len(body), 2835, 2835, colors, 0)
        extra = b""
        if compression == 3 and header >= 52:
            m = list(masks) + [0] * (4 - len(masks))
            extra = struct.pack("<IIII", *m)[: (16 if header >= 56 else 12)]
        dib += extra + b"\0" * (header - len(dib) - len(extra))
        if compression == 3 and header == 40:
            dib += struct.pack("<III", *masks[:3])
    offset = 14 + len(dib) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + dib + pal + body


# ---------------------------------------------------------------- ICO


def ico(entries: List[bytes], dims: List[tuple], bpps: List[int]) -> bytes:
    """An icon of ``entries`` (PNG files or DIBs), with their directory
    widths/heights and bit counts."""
    head = struct.pack("<HHH", 0, 1, len(entries))
    offset = 6 + 16 * len(entries)
    directory, body = b"", b""
    for data, (w, h), bpp in zip(entries, dims, bpps):
        directory += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp, len(data),
                                 offset + len(body))
        body += data
    return head + directory + body


def ico_dib(rgb_idx: np.ndarray, *, bits: int, palette=None, mask=None,
            alpha=None) -> bytes:
    """A DIB entry: the XOR bitmap (doubled height in its header) and the
    AND mask (1 = transparent); 32-bit entries carry ``alpha`` in the
    fourth byte."""
    h, w = rgb_idx.shape[:2]
    if bits == 32:
        px = np.dstack([rgb_idx[..., 2], rgb_idx[..., 1], rgb_idx[..., 0],
                        alpha if alpha is not None else np.full((h, w), 255, np.uint8)])
        xor = px[::-1].reshape(h, -1).tobytes()
    elif bits == 24:
        stride = ((w * 24 + 31) >> 3) & ~3
        out = np.zeros((h, stride), np.uint8)
        out[:, : 3 * w] = rgb_idx[::-1][..., ::-1].reshape(h, -1)
        xor = out.tobytes()
    else:
        xor = _pack_rows(rgb_idx[::-1], bits).tobytes()
    pal = b""
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:, ::-1]
        pal = np.concatenate([entries, np.zeros((len(entries), 1), np.uint8)], 1).tobytes()
    m = mask if mask is not None else np.zeros((h, w), np.uint8)
    and_mask = _pack_rows(m[::-1].astype(np.uint8), 1).tobytes()
    dib = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                      len(palette) if palette is not None else 0, 0)
    return dib + pal + xor + and_mask


# ---------------------------------------------------------------- TIFF


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: codes from the most significant bit,
    a clear code first and when the table reaches 4094 entries."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    table, nxt = {}, 258
    put(256)
    if data:
        cur = data[0]
        for b in data[1:]:
            if (cur, b) in table:
                cur = table[(cur, b)]
                continue
            put(cur)
            if nxt == 4094:
                put(256)
                table, nxt, width = {}, 258, 9
            else:
                table[(cur, b)] = nxt
                nxt += 1
                if nxt == (1 << width) and width < 12:
                    width += 1
            cur = b
        put(cur)
        # the decoder adds an entry on the last code, and may widen for EOI
        if nxt + 1 == (1 << width) and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        k = i
        while k < len(data) and k - i < 128 and not (
                k + 1 < len(data) and data[k] == data[k + 1]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    raise ValueError(compression)


def _predict(block: np.ndarray, spp: int, bits: int, bo: str) -> np.ndarray:
    """Horizontal differencing of [rows, width, spp] samples."""
    if bits == 8:
        diff = block.astype(np.int16).copy()
        diff[:, 1:] -= block[:, :-1].astype(np.int16)
        return (diff % 256).astype(np.uint8)
    diff = block.astype(np.int64).copy()
    diff[:, 1:] -= block[:, :-1].astype(np.int64)
    return (diff % 65536).astype(bo + "u2")


def _samples_bytes(block: np.ndarray, bits: int, bo: str) -> bytes:
    """[rows, width, spp] samples -> row-padded bytes."""
    rows, w, spp = block.shape
    if bits == 16:
        return block.astype(bo + "u2").tobytes()
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    return _pack_rows(block[..., 0], bits)[:, : -(-w * bits // 8)].tobytes()


def tiff(pages: List[dict], *, big_endian: bool = False) -> bytes:
    """A TIFF of ``pages``: dicts with ``samples`` ([h, w, spp] uint8 or
    uint16), ``bits``, ``photometric`` and optionally ``extra`` (extra
    samples), ``compression`` (1, 5, 8, 32773), ``predictor``,
    ``rows_per_strip`` or ``tile`` ((tw, th)), ``colormap`` ([3 * 2**bits]
    16-bit values) and ``orientation``; or, for another compression, the
    strips' or tiles' bytes as ``blobs`` (``samples`` then gives only the
    shape) and any more tags as ``tags`` ([(tag, type, values)], type 3, 4
    or 7 for bytes)."""
    bo = ">" if big_endian else "<"
    out = bytearray((b"MM\x00*" if big_endian else b"II*\x00") + b"\0\0\0\0")
    ifd_offsets = []
    for page in pages:
        s = np.asarray(page["samples"])
        h, w, spp = s.shape
        bits, comp = page["bits"], page.get("compression", 1)
        pred = page.get("predictor", 1)
        blobs, tags = [], list(page.get("tags", ()))
        if "blobs" in page:
            blobs = list(page["blobs"])
        elif "tile" in page:
            tw, th = page["tile"]
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    block = np.zeros((th, tw, spp), s.dtype)
                    part = s[ty:ty + th, tx:tx + tw]
                    block[: part.shape[0], : part.shape[1]] = part
                    if pred == 2:
                        block = _predict(block, spp, bits, bo)
                    blobs.append(_compress(_samples_bytes(block, bits, bo), comp))
        else:
            per = page.get("rows_per_strip", h)
            for y0 in range(0, h, per):
                block = s[y0:y0 + per]
                if pred == 2:
                    block = _predict(block, spp, bits, bo)
                blobs.append(_compress(_samples_bytes(block, bits, bo), comp))
        offsets = []
        for blob in blobs:
            offsets.append(len(out))
            out += blob
            if len(out) % 2:
                out += b"\0"
        tags += [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
                 (262, 3, [page["photometric"]]), (277, 3, [spp])]
        if "tile" in page:
            tags += [(322, 3, [page["tile"][0]]), (323, 3, [page["tile"][1]]),
                     (324, 4, offsets), (325, 4, [len(b) for b in blobs])]
        else:
            tags += [(273, 4, offsets), (278, 4, [page.get("rows_per_strip", h)]),
                     (279, 4, [len(b) for b in blobs])]
        if pred != 1:
            tags.append((317, 3, [pred]))
        if page.get("extra") is not None:
            tags.append((338, 3, list(page["extra"])))
        if page.get("colormap") is not None:
            tags.append((320, 3, list(page["colormap"])))
        if page.get("orientation"):
            tags.append((274, 3, [page["orientation"]]))
        tags.sort()
        # values that do not fit in the entry go before the IFD
        entries = []
        for tag, typ, vals in tags:
            fmt = {3: "H", 4: "I", 7: "B"}[typ]
            raw = struct.pack(bo + fmt * len(vals), *vals)
            if len(raw) <= 4:
                entries.append((tag, typ, len(vals), raw.ljust(4, b"\0")))
            else:
                at = len(out)
                out += raw + (b"\0" if len(raw) % 2 else b"")
                entries.append((tag, typ, len(vals), struct.pack(bo + "I", at)))
        ifd_offsets.append(len(out))
        out += struct.pack(bo + "H", len(entries))
        for tag, typ, n, val in entries:
            out += struct.pack(bo + "HHI", tag, typ, n) + val
        out += b"\0\0\0\0"
    struct.pack_into(bo + "I", out, 4, ifd_offsets[0])
    for k in range(len(ifd_offsets) - 1):
        nxt_field = ifd_offsets[k] + 2 + 12 * struct.unpack_from(bo + "H", out, ifd_offsets[k])[0]
        struct.pack_into(bo + "I", out, nxt_field, ifd_offsets[k + 1])
    return bytes(out)
