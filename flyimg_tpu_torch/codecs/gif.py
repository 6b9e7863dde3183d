"""GIF decode and encode, still and animated, for the port's host codec layer.

The port's counterpart of the JAX package's GIF path, which runs on Pillow
(``pil_codec.decode``, the handler's ``_decode_all_frames`` and
``_encode_gif_animation``); the card machine has no Pillow or giflib. The
container is read and written here; LZW and the quantizer are C++
(``codecs/native/gif.cpp``, through ``rasterlib``).

Decode follows Pillow 12's GifImagePlugin frame by frame, so every frame
equals Pillow's composited one: the first frame stays palette ("P") or gray
("L", when no colour table is needed); from the second frame on the canvas
is RGB, or RGBA when the first frame had a transparent index; a frame is
drawn into a buffer filled with its transparent index, converted with its
own colour table and pasted over the canvas through its alpha. Disposal
2 fills the frame's box with the transparent index's colour (alpha 0) or the
background colour, disposal 3 restores the box as it was before the frame;
a frame without a disposal keeps the last one given. A frame that reaches
past the logical screen widens it, as Pillow does: the canvas grows, filled
with zeros (a gray or palette canvas), with transparent black (the frame has
a transparent index: the canvas becomes RGBA) or with the colour of the
frame's index 0 (it has none: the canvas becomes RGB). A colour table after
a gray first frame raises.

Encode follows Pillow's writer: the adaptive palette by median cut with no
dither, the palette trimmed of unused entries on small frames, LZW with a
code size of 8; a still frame is interlaced when both sides are 16 or more.
An animation's frames after the first are cropped to the box that differs
from the frame before (from a transparent canvas under disposal 2), carry
their own colour table, and mark unchanged pixels with an unused index when
there is one; a frame equal to the one before merges into it, adding its
duration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import rasterlib
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)


@dataclass
class Animation:
    """All frames of an animation, composited (the JAX handler's
    ``_Animation``)."""

    frames: list            # [h, w, 3] uint8 per frame
    alphas: Optional[list]  # [h, w] uint8 per frame; None = fully opaque
    durations: list         # ms per frame
    loop: Optional[int]     # NETSCAPE loop count; None = play once


@dataclass
class _Frame:
    extent: Tuple[int, int, int, int]      # x0, y0, x1, y1
    interlace: bool
    local: object                          # None, False (gray ramp) or [n, 3]
    transparency: Optional[int]
    duration: Optional[int]                # ms; None without a GCE
    dispose_bits: int
    code_size: int
    blocks: List[Tuple[int, int]]          # (start, end) of each sub-block


@dataclass
class _Parsed:
    size: Tuple[int, int]
    global_palette: object                 # None or [n, 3]
    background: Optional[int]
    loop: Optional[int]
    frames: List[_Frame]


def _palette(raw: bytes):
    """A colour table -> [n, 3], or False when it is the gray ramp (Pillow
    then reads the frame as gray)."""
    pal = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(pal), dtype=np.uint8)
    if (pal == ramp[:, None]).all() and len(pal) <= 256:
        return False
    return pal


def _parse(data: bytes) -> _Parsed:
    """The container, as GifImagePlugin walks it."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ExecFailedException("not a GIF file")
    size = (int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little"))
    flags, pos = data[10], 13
    global_palette, background = None, None
    if flags & 128:
        background = data[11]
        n = 3 << ((flags & 7) + 1)
        pal = _palette(data[pos:pos + n]) if pos + n <= len(data) else None
        global_palette = pal if pal is not False else None
        pos += n
    loop = None
    frames: List[_Frame] = []

    def sub_blocks(p: int):
        out = []
        while p < len(data) and data[p]:
            out.append((p + 1, min(p + 1 + data[p], len(data))))
            p += 1 + data[p]
        return out, p + 1

    while pos < len(data):
        transparency, duration, dispose_bits = None, None, 0
        local, frame = None, None
        while pos < len(data):
            s = data[pos]
            pos += 1
            if s == 0x3B:  # ';'
                break
            if s == 0x21:  # '!' extension
                if pos >= len(data):
                    break
                label = data[pos]
                blocks, end = sub_blocks(pos + 1)
                first = data[blocks[0][0]:blocks[0][1]] if blocks else None
                if label == 249 and first is not None and len(first) >= 3:
                    if first[0] & 1 and len(first) >= 4:
                        transparency = first[3]
                    duration = int.from_bytes(first[1:3], "little") * 10
                    dispose_bits = (first[0] & 0b00011100) >> 2
                elif (label == 255 and not frames and first is not None
                      and first.startswith(b"NETSCAPE2.0") and len(blocks) > 1):
                    nxt = data[blocks[1][0]:blocks[1][1]]
                    if len(nxt) >= 3 and nxt[0] == 1:
                        loop = int.from_bytes(nxt[1:3], "little")
                pos = end
            elif s == 0x2C:  # ',' image descriptor
                d = data[pos:pos + 9]
                if len(d) < 9:
                    break
                pos += 9
                x0, y0 = int.from_bytes(d[0:2], "little"), int.from_bytes(d[2:4], "little")
                x1 = x0 + int.from_bytes(d[4:6], "little")
                y1 = y0 + int.from_bytes(d[6:8], "little")
                if d[8] & 128:
                    n = 3 << ((d[8] & 7) + 1)
                    local = _palette(data[pos:pos + n])
                    pos += n
                code_size = data[pos] if pos < len(data) else 0
                blocks, pos = sub_blocks(pos + 1)
                frame = _Frame((x0, y0, x1, y1), bool(d[8] & 64), local, transparency,
                               duration, dispose_bits, code_size, blocks)
                break
        if frame is None:
            break
        frames.append(frame)
    if not frames:
        raise ExecFailedException("image not found in GIF file")
    return _Parsed(size, global_palette, background, loop, frames)


def _table(pal) -> np.ndarray:
    """A colour table as a core palette: 256 entries, those past the table
    black."""
    table = np.zeros((256, 3), np.uint8)
    if pal is not None and pal is not False:
        table[:len(pal)] = pal[:256]
    return table


def _rgb(pal, color: int) -> Tuple[int, int, int]:
    """GifImagePlugin's ``_rgb``: an index in the frame's table (index 0 past
    its end), or gray without a table."""
    if pal is not None and pal is not False:
        if color >= len(pal):
            color = 0
        return tuple(int(v) for v in pal[color])
    return (color, color, color)


_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))

#: the most pixels a widened screen may hold (twice the JAX package's
#: ``Image.MAX_IMAGE_PIXELS``, where Pillow's bomb check raises)
MAX_PIXELS = 2 * 512 * 1024 * 1024


def _crop(canvas: np.ndarray, extent) -> np.ndarray:
    """``Image.crop``: the box of ``canvas``, zeros where it lies past the
    canvas."""
    x0, y0, x1, y1 = extent
    out = np.zeros((y1 - y0, x1 - x0) + canvas.shape[2:], np.uint8)
    part = canvas[y0:y1, x0:x1]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _frame_indices(data: bytes, fr: _Frame) -> Tuple[np.ndarray, np.ndarray]:
    """A frame's LZW data -> (indices [h, w], written mask [h, w]); a stream
    that ends early writes its leading pixels only."""
    x0, y0, x1, y1 = fr.extent
    w, h = x1 - x0, y1 - y0
    stream = b"".join(data[a:b] for a, b in fr.blocks)
    if not 1 <= fr.code_size <= 11:
        raise ExecFailedException(f"GIF LZW code size {fr.code_size} is out of range")
    flat, status = rasterlib.gif_lzw_decode(stream, fr.code_size, w * h)
    if status == 1:
        raise ExecFailedException("image file is truncated (GIF LZW data)")
    order = np.arange(h)
    if fr.interlace:
        order = np.concatenate([np.arange(start, h, step) for start, step in _INTERLACE])
    idx = np.zeros((h, w), np.uint8)
    written = np.zeros((h, w), bool)
    n = flat.size
    full, rest = divmod(n, w) if w else (0, 0)
    rows = order[:full]
    idx[rows] = flat[: full * w].reshape(full, w)
    written[rows] = True
    if rest and full < h:
        idx[order[full], :rest] = flat[full * w:]
        written[order[full], :rest] = True
    return idx, written


class _Decoder:
    """GifImagePlugin's frame state, frame by frame. An RGB canvas keeps
    four bytes a pixel as Pillow's does: the fourth is 255 where a frame or
    a fill wrote it and 0 where a crop past the canvas did, and a widening
    with a transparent index makes it the alpha plane."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.parsed = _parse(data)
        self.size = self.parsed.size
        self.n = -1
        self.mode = ""
        self.canvas: Optional[np.ndarray] = None
        self.canvas_table: Optional[np.ndarray] = None
        self.info_t: Optional[int] = None
        self.disposal = 0
        self.dispose: Optional[np.ndarray] = None
        self.dispose_extent = None
        self.duration: Optional[int] = None

    def step(self) -> None:
        """Seek and load the next frame."""
        n = self.n = self.n + 1
        fr = self.parsed.frames[n]
        x0, y0, x1, y1 = fr.extent
        if x1 > self.size[0] or y1 > self.size[1]:
            self.size = (max(x1, self.size[0]), max(y1, self.size[1]))
            if self.size[0] * self.size[1] > MAX_PIXELS:
                raise ExecFailedException(
                    f"a GIF screen of {self.size[0]}x{self.size[1]} exceeds the "
                    f"{MAX_PIXELS}-pixel decode limit")
        if n and self.dispose is not None:
            dx0, dy0, dx1, dy1 = self.dispose_extent
            self.canvas[dy0:dy1, dx0:dx1] = self.dispose
        frame_pal = fr.local if fr.local is not None else self.parsed.global_palette
        has_pal = frame_pal is not None and frame_pal is not False
        if n == 0:
            self.mode = "P" if has_pal else "L"
            self.canvas_table = _table(frame_pal) if has_pal else None
        elif self.mode == "P":
            rgb = self.canvas_table[self.canvas]
            alpha = np.full(rgb.shape[:2], 255, np.uint8)
            if self.info_t is not None:
                alpha[self.canvas == self.info_t] = 0
            self.mode = "RGBA" if self.info_t is not None else "RGB"
            self.canvas, self.info_t = np.dstack([rgb, alpha]), None
        if fr.dispose_bits:
            self.disposal = fr.dispose_bits
        self.duration = fr.duration
        rgb_mode = self.mode in ("RGB", "RGBA")
        box = (y1 - y0, x1 - x0)
        self.dispose, self.dispose_extent = None, fr.extent
        if self.disposal == 2:
            color = self.info_t if self.info_t is not None else fr.transparency
            if color is not None:
                fill = (*_rgb(frame_pal, color), 0) if rgb_mode else color
            else:
                color = self.parsed.background or 0
                fill = (*_rgb(frame_pal, color), 255) if rgb_mode else color
            self.dispose = self._patch(box, fill)
        elif self.disposal == 3:
            if n:
                self.dispose = _crop(self.canvas, fr.extent)
            elif fr.transparency is not None:
                self.dispose = self._patch(box, fr.transparency)
        if n == 0 and fr.transparency is not None:
            self.info_t = fr.transparency

        idx, written = _frame_indices(self.data, fr)
        w, h = self.size
        if n and self.canvas.shape[:2] != (h, w):
            self._widen(fr, frame_pal, has_pal)
            rgb_mode = self.mode in ("RGB", "RGBA")
        if n == 0:
            fill = fr.transparency if fr.transparency is not None else 0
            self.canvas = np.full((h, w), fill, np.uint8)
            region = self.canvas[y0:y1, x0:x1]
            region[written] = idx[written]
        elif rgb_mode:
            buf = np.full(box, (fr.transparency or 0) if has_pal else 0, np.uint8)
            buf[written] = idx[written]
            if has_pal:
                rgb = _table(frame_pal)[buf]
            else:
                rgb = np.repeat(buf[..., None], 3, axis=2)
            region = self.canvas[y0:y1, x0:x1]
            if fr.transparency is not None:
                opaque = buf != fr.transparency
                region[opaque, :3] = rgb[opaque]
                region[opaque, 3] = 255
            else:
                region[..., :3] = rgb
                region[..., 3] = 255
        else:  # gray from the first frame on
            if has_pal:
                raise UnsupportedMediaException(
                    "a GIF colour table after a gray first frame is not ported to "
                    "the PyTorch package yet")
            keep = written if fr.transparency is None else written & (idx != fr.transparency)
            region = self.canvas[y0:y1, x0:x1]
            region[keep] = idx[keep]

    def _widen(self, fr: _Frame, frame_pal, has_pal: bool) -> None:
        """The canvas grown to the screen, as GifImagePlugin's
        ``load_prepare`` (a gray canvas) and ``load_end`` (an RGB or RGBA
        one) grow it."""
        w, h = self.size
        old = self.canvas
        ph, pw = old.shape[:2]
        grown = np.zeros((h, w) + old.shape[2:], np.uint8)
        if self.mode in ("RGB", "RGBA"):
            if fr.transparency is not None:
                self.mode = "RGBA"
            elif not has_pal:
                raise ExecFailedException(
                    "GIF decode failed: a frame without a colour table widens an RGB screen")
            else:
                grown[:] = (*_table(frame_pal)[0], 255)
                self.mode = "RGB"
        grown[:ph, :pw] = old
        self.canvas = grown

    def _patch(self, box, fill) -> np.ndarray:
        if self.mode in ("RGB", "RGBA"):
            return np.broadcast_to(np.asarray(fill, np.uint8), (*box, 4)).copy()
        return np.full(box, fill, np.uint8)

    def rgba(self) -> np.ndarray:
        """The frame as ``convert("RGBA")`` gives it."""
        if self.mode == "RGBA":
            return self.canvas.copy()
        if self.mode == "RGB":
            rgb = self.canvas[..., :3]
        elif self.mode == "P":
            rgb = self.canvas_table[self.canvas]
        else:
            rgb = np.repeat(self.canvas[..., None], 3, axis=2)
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
        if self.mode in ("P", "L") and self.info_t is not None:
            alpha[self.canvas == self.info_t] = 0
        return np.dstack([rgb, alpha])

    def split(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The frame as ``pil_codec.decode`` gives it: RGBA split when the
        mode is RGBA, or palette with a transparent index; RGB otherwise
        (a gray frame with one included)."""
        if self.mode == "RGBA" or (self.mode == "P" and self.info_t is not None):
            rgba = self.rgba()
            return np.ascontiguousarray(rgba[..., :3]), np.ascontiguousarray(rgba[..., 3])
        return np.ascontiguousarray(self.rgba()[..., :3]), None


def decode(data: bytes, frame: int = 0) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """GIF bytes -> (rgb [h, w, 3], alpha [h, w] or None, n_frames): frame
    ``min(frame, n_frames - 1)``, composited, as ``pil_codec.decode``
    gives it."""
    dec = _Decoder(data)
    total = len(dec.parsed.frames)
    target = min(max(int(frame), 0), total - 1) if total > 1 else 0
    for _ in range(target + 1):
        dec.step()
    rgb, alpha = dec.split()
    return rgb, alpha, total


def decode_all(data: bytes) -> Animation:
    """Every frame, composited, with its duration (100 without a GCE) and
    the NETSCAPE loop count (None: play once), as the JAX handler's
    ``_decode_all_frames`` reads them."""
    dec = _Decoder(data)
    frames, alphas, durations = [], [], []
    any_alpha = False
    for _ in dec.parsed.frames:
        dec.step()
        rgba = dec.rgba()
        frames.append(np.ascontiguousarray(rgba[..., :3]))
        alpha = np.ascontiguousarray(rgba[..., 3])
        any_alpha |= bool(alpha.min() < 255)
        alphas.append(alpha)
        durations.append(100 if dec.duration is None else dec.duration)
    return Animation(frames=frames, alphas=alphas if any_alpha else None,
                     durations=durations, loop=dec.parsed.loop)


# ---------------------------------------------------------------- encode


@dataclass
class _Out:
    """One frame to write: indices, colour table, and its GCE fields."""

    idx: np.ndarray
    palette: np.ndarray
    duration: Optional[int]
    transparency: Optional[int] = None
    disposal: int = 0
    bbox: Optional[Tuple[int, int, int, int]] = None


def _optimize(idx: np.ndarray, palette: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """GifImagePlugin's ``_get_optimize`` with ``optimize`` on: a frame under
    512x512 pixels drops its unused entries when there is a hole, or when
    the entries in use fit a table half the size."""
    if idx.size >= 512 * 512:
        return idx, palette
    counts = np.bincount(idx.reshape(-1), minlength=256)
    used = np.flatnonzero(counts)
    size = 1 << (len(palette) - 1).bit_length()
    if used.max() >= len(used) or (len(used) <= size // 2 and size > 2):
        remap = np.zeros(256, np.uint8)
        remap[used] = np.arange(len(used), dtype=np.uint8)
        return remap[idx], palette[used]
    return idx, palette


def _table_size(n: int) -> int:
    """The colour table's size field for ``n`` entries."""
    if n == 0:
        return 0
    if n * 3 < 9:
        return 1
    return int(np.ceil(np.log2(n))) - 1


def _header_palette(palette: np.ndarray) -> bytes:
    size = _table_size(len(palette))
    out = np.zeros((2 << size, 3), np.uint8)
    out[:len(palette)] = palette
    return out.tobytes()


def _gce(duration: Optional[int], transparency: Optional[int], disposal: int) -> bytes:
    delay = int(duration / 10) if duration else 0
    if transparency is None and delay == 0 and not disposal:
        return b""
    packed = (1 if transparency is not None else 0) | (disposal << 2)
    return (b"!\xf9\x04" + bytes([packed]) + delay.to_bytes(2, "little")
            + bytes([transparency or 0, 0]))


def _global_header(w: int, h: int, palette: np.ndarray, *, transparency, loop,
                   duration) -> bytes:
    version = b"89a" if (transparency is not None or loop is not None or duration) else b"87a"
    out = (b"GIF" + version + w.to_bytes(2, "little") + h.to_bytes(2, "little")
           + bytes([_table_size(len(palette)) + 128, 0, 0]) + _header_palette(palette))
    if loop is not None:
        out += (b"!\xff\x0bNETSCAPE2.0\x03\x01" + int(loop).to_bytes(2, "little") + b"\x00")
    return out


def _image(idx: np.ndarray, offset: Tuple[int, int], *, palette=None,
           interlace: bool = False) -> bytes:
    """An image descriptor (with a local colour table when ``palette`` is
    given) and its LZW data."""
    h, w = idx.shape
    flags = 64 if interlace else 0
    table = b""
    if palette is not None:
        size = _table_size(len(palette))
        flags |= 128 | size
        table = _header_palette(palette)
    if interlace:
        idx = idx[np.concatenate([np.arange(s, h, st) for s, st in _INTERLACE])]
    return (b"," + offset[0].to_bytes(2, "little") + offset[1].to_bytes(2, "little")
            + w.to_bytes(2, "little") + h.to_bytes(2, "little") + bytes([flags]) + table
            + rasterlib.gif_lzw_encode(idx, 8))


def _still(idx, palette, *, duration=None, transparency=None, disposal=0, loop=None) -> bytes:
    """GifImagePlugin's ``_write_single_frame``."""
    h, w = idx.shape
    return (_global_header(w, h, palette, transparency=transparency, loop=loop,
                           duration=duration)
            + _gce(duration, transparency, disposal)
            + _image(idx, (0, 0), interlace=min(w, h) >= 16) + b";")


def encode(rgb: np.ndarray) -> bytes:
    """[h, w, 3] uint8 -> a still GIF, as Pillow's ``save(..., "GIF")``
    writes an RGB image."""
    palette, idx = rasterlib.quantize(rgb, 256)
    idx, palette = _optimize(idx, palette)
    return _still(idx, palette)


def _rgba(idx: np.ndarray, palette: np.ndarray, transparency: Optional[int]) -> np.ndarray:
    rgb = _table(palette)[idx]
    alpha = np.full(idx.shape, 255, np.uint8)
    if transparency is not None:
        alpha[idx == transparency] = 0
    return np.dstack([rgb, alpha])


def _delta(a: _Out, b: _Out) -> np.ndarray:
    """Where ``b`` differs from ``a``: by index under one colour table, else
    by RGBA (``_getbbox``)."""
    if a.palette.shape == b.palette.shape and (a.palette == b.palette).all():
        return a.idx != b.idx
    return (_rgba(a.idx, a.palette, a.transparency)
            != _rgba(b.idx, b.palette, b.transparency)).any(axis=2)


def _bbox(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    rows, cols = np.flatnonzero(mask.any(axis=1)), np.flatnonzero(mask.any(axis=0))
    if not rows.size:
        return None
    return (int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1)


def _unused_index(idx: np.ndarray, palette: np.ndarray) -> Optional[int]:
    """``ImagePalette._new_color_index``: the first index past the table,
    else the highest one no pixel uses."""
    if len(palette) < 256:
        return len(palette)
    free = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256) == 0)
    return int(free[-1]) if free.size else None


def encode_animation(frames, alphas=None, durations=None, loop=None) -> bytes:
    """Frames ([h, w, 3] uint8) -> an animated GIF, as the JAX handler's
    ``_encode_gif_animation`` writes it through Pillow: 256 colours a
    frame; with ``alphas``, 255 colours and index 255 where alpha < 128,
    marked transparent, every frame disposed to the background. ``loop``
    None writes no NETSCAPE block (play once)."""
    if not len(frames):
        raise ExecFailedException("an animation needs a frame")
    if durations is None or not len(durations):
        durations = [100] * len(frames)
    transparent = alphas is not None
    kept: List[_Out] = []
    previous: Optional[_Out] = None
    background = None
    for i, frame in enumerate(frames):
        if transparent:
            palette, idx = rasterlib.quantize(frame, 255)
            idx = np.where(np.asarray(alphas[i]) < 128, 255, idx).astype(np.uint8)
            out = _Out(idx, palette, durations[i], 255, 2)
        else:
            palette, idx = rasterlib.quantize(frame, 256)
            idx, palette = _optimize(idx, palette)
            out = _Out(idx, palette, durations[i])
        # the frame as quantized (its transparent index is the encoder's
        # only on the transparent path) is what the next frame compares to
        current = _Out(idx, palette, None, 255 if transparent else None)
        if previous is not None:
            changed = _delta(previous, current)
            if _bbox(changed) is None:
                if out.duration:
                    kept[-1].duration = (kept[-1].duration or 0) + out.duration
                continue
            if transparent:
                if background is None:
                    background = _Out(np.full(idx.shape, 255, np.uint8), kept[0].palette, None)
                out.bbox = _bbox(_delta(background, current))
            else:
                out.bbox = _bbox(changed)
                unused = _unused_index(idx, palette)
                if unused is not None:
                    out.transparency = unused
                    out.idx = np.where(changed, idx, unused).astype(np.uint8)
        previous = current
        kept.append(out)
    first = kept[0]
    h, w = first.idx.shape
    if len(kept) == 1:
        return _still(first.idx, first.palette, duration=first.duration,
                      transparency=255 if transparent else None,
                      disposal=2 if transparent else 0, loop=loop)
    parts = [_global_header(w, h, first.palette, transparency=first.transparency,
                            loop=loop, duration=first.duration)]
    for out in kept:
        parts.append(_gce(out.duration, out.transparency, out.disposal))
        if out.bbox is None:
            parts.append(_image(out.idx, (0, 0)))
            continue
        x0, y0, x1, y1 = out.bbox
        parts.append(_image(out.idx[y0:y1, x0:x1], (x0, y0), palette=out.palette))
    parts.append(b";")
    return b"".join(parts)
