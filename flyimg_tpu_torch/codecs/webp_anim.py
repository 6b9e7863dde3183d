"""Animated WebP sources for the port's host codec layer.

The JAX package reads an animated WebP through Pillow, which runs libwebp's
``WebPAnimDecoder``; the card machine has neither. This module reads the
``VP8X``/``ANIM``/``ANMF`` container, decodes each frame's ``VP8`` (with
its ``ALPH``) or ``VP8L`` bitstream with the port's own WebP decoder
(``native_codec.webp_decode_auto``), and composites the canvas as libwebp's
``anim_decode.c`` does, in non-premultiplied RGBA:

- the canvas starts transparent black; a key frame (the first, a full-canvas
  frame without alpha or without blending, or a frame after one disposed to
  the background that was full-canvas or itself a key frame) starts from a
  transparent canvas, any other from the previous canvas as disposed;
- a frame's pixels replace the canvas in its rectangle (offsets are even);
  with blending, pixels whose alpha is below 255 are blended over the
  previous canvas (outside the previous frame's rectangle when that frame
  was disposed to the background);
- disposing to the background clears the frame's rectangle to transparent.

``decode`` gives the canvas after frame ``N`` as Pillow's ``seek(N)`` does
(RGBA when the file declares alpha, else RGB); ``decode_all`` gives every
canvas with its duration and the ``ANIM`` loop count.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import native_codec
from flyimg_tpu_torch.codecs.gif import Animation
from flyimg_tpu_torch.exceptions import ExecFailedException


@dataclass
class _AnimFrame:
    x: int
    y: int
    w: int
    h: int
    duration: int
    blend: bool
    dispose_background: bool
    has_alpha: bool
    payload: bytes      # a RIFF/WEBP file of the frame's bitstream alone


@dataclass
class _AnimFile:
    size: Tuple[int, int]
    alpha: bool
    loop: int
    frames: List[_AnimFrame]


def _chunks(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ExecFailedException("WebP decode failed: a chunk runs past the file")
        yield fourcc, body
        pos += 8 + size + (size & 1)


def _riff(chunks: List[Tuple[bytes, bytes]]) -> bytes:
    body = b"".join(c + struct.pack("<I", len(b)) + b + (b"\0" if len(b) & 1 else b"")
                    for c, b in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def is_animated(data: bytes) -> bool:
    """True for an extended WebP file with the animation flag."""
    return (len(data) >= 21 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"
            and data[12:16] == b"VP8X" and bool(data[20] & 0x02))


def _parse(data: bytes) -> _AnimFile:
    end = min(len(data), struct.unpack("<I", data[4:8])[0] + 8)
    size, alpha, loop, frames = None, False, 0, []
    for fourcc, body in _chunks(data, 12, end):
        if fourcc == b"VP8X" and len(body) >= 10:
            alpha = bool(body[0] & 0x10)
            size = (int.from_bytes(body[4:7], "little") + 1,
                    int.from_bytes(body[7:10], "little") + 1)
        elif fourcc == b"ANIM" and len(body) >= 6:
            loop = struct.unpack("<H", body[4:6])[0]
        elif fourcc == b"ANMF" and len(body) >= 16:
            x = 2 * int.from_bytes(body[0:3], "little")
            y = 2 * int.from_bytes(body[3:6], "little")
            w = int.from_bytes(body[6:9], "little") + 1
            h = int.from_bytes(body[9:12], "little") + 1
            duration = int.from_bytes(body[12:15], "little")
            flags = body[15]
            alph, image = None, None
            for sub, sbody in _chunks(body, 16, len(body)):
                if sub == b"ALPH" and alph is None and image is None:
                    alph = sbody
                elif sub in (b"VP8 ", b"VP8L"):
                    image = (sub, sbody)
                    break
            if image is None:
                raise ExecFailedException("WebP decode failed: an ANMF frame has no bitstream")
            if image[0] == b"VP8L":
                has_alpha = len(image[1]) >= 5 and bool(image[1][4] & 0x10)
                payload = _riff([image])
            elif alph is not None:
                has_alpha = True
                vp8x = bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") \
                    + (h - 1).to_bytes(3, "little")
                payload = _riff([(b"VP8X", vp8x), (b"ALPH", alph), image])
            else:
                has_alpha = False
                payload = _riff([image])
            frames.append(_AnimFrame(x, y, w, h, duration, not flags & 0x02,
                                     bool(flags & 0x01), has_alpha, payload))
    if size is None or not frames:
        raise ExecFailedException("WebP decode failed: not an animation")
    for f in frames:
        if f.x + f.w > size[0] or f.y + f.h > size[1]:
            raise ExecFailedException("WebP decode failed: a frame outside the canvas")
    return _AnimFile(size, alpha, loop, frames)


def _frame_rgba(frame: _AnimFrame) -> np.ndarray:
    pixels, channels = native_codec.webp_decode_auto(frame.payload)
    if pixels.shape[:2] != (frame.h, frame.w):
        raise ExecFailedException("WebP decode failed: a frame is not its ANMF size")
    if channels == 3:
        pixels = np.dstack([pixels, np.full((frame.h, frame.w), 255, np.uint8)])
    return pixels


def _blend(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """anim_decode.c's BlendPixelNonPremult on [..., 4] uint8, for pixels
    whose alpha is below 255; an alpha of 0 leaves ``dst``."""
    s = src.astype(np.uint32)
    d = dst.astype(np.uint32)
    sa, da = s[..., 3], d[..., 3]
    dfa = (da * (256 - sa)) >> 8
    ba = sa + dfa
    scale = np.where(ba > 0, (1 << 24) // np.maximum(ba, 1), 0)
    out = np.empty_like(src)
    for c in range(3):
        out[..., c] = (((s[..., c] * sa + d[..., c] * dfa) * scale) >> 24).astype(np.uint8)
    out[..., 3] = ba.astype(np.uint8)
    out = np.where((sa == 0)[..., None], dst, out)
    return np.where((sa == 255)[..., None], src, out)


class _Compositor:
    def __init__(self, data: bytes) -> None:
        self.file = _parse(data)
        w, h = self.file.size
        self.canvas = np.zeros((h, w, 4), np.uint8)
        self.disposed = np.zeros((h, w, 4), np.uint8)
        self.prev: Optional[_AnimFrame] = None
        self.prev_key = False
        self.n = 0

    def _key(self, f: _AnimFrame) -> bool:
        full = lambda g: (g.w, g.h) == self.file.size  # noqa: E731
        if self.n == 0:
            return True
        if (not f.has_alpha or not f.blend) and full(f):
            return True
        return self.prev.dispose_background and (full(self.prev) or self.prev_key)

    def step(self) -> _AnimFrame:
        f = self.file.frames[self.n]
        key = self._key(f)
        self.canvas = np.zeros_like(self.canvas) if key else self.disposed.copy()
        rect = (slice(f.y, f.y + f.h), slice(f.x, f.x + f.w))
        self.canvas[rect] = _frame_rgba(f)
        if self.n > 0 and f.blend and not key:
            region = np.ones((f.h, f.w), bool)
            p = self.prev
            if p.dispose_background:
                ys = np.arange(f.y, f.y + f.h)[:, None]
                xs = np.arange(f.x, f.x + f.w)[None, :]
                region = ~((ys >= p.y) & (ys < p.y + p.h) & (xs >= p.x) & (xs < p.x + p.w))
            cur, old = self.canvas[rect], self.disposed[rect]
            cur[region] = _blend(cur[region], old[region])
        self.disposed = self.canvas.copy()
        if f.dispose_background:
            self.disposed[rect] = 0
        self.prev, self.prev_key = f, key
        self.n += 1
        return f

    def output(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rgb = np.ascontiguousarray(self.canvas[..., :3])
        alpha = np.ascontiguousarray(self.canvas[..., 3]) if self.file.alpha else None
        return rgb, alpha


def decode(data: bytes, frame: int = 0) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """An animated WebP -> (rgb, alpha or None, n_frames): the canvas after
    frame ``min(frame, n_frames - 1)``; alpha when the file declares it."""
    comp = _Compositor(data)
    total = len(comp.file.frames)
    target = min(max(int(frame), 0), total - 1) if total > 1 else 0
    for _ in range(target + 1):
        comp.step()
    rgb, alpha = comp.output()
    return rgb, alpha, total


def decode_all(data: bytes) -> Animation:
    """Every canvas with a duration and the ANIM loop count (0: forever),
    as the JAX handler reads them through Pillow. Pillow's WebP reader sets
    a frame's ``duration`` when it loads the frame, and the handler reads
    it before, so each frame carries the one before's (the first, 100)."""
    comp = _Compositor(data)
    frames, alphas, durations = [], [], []
    any_alpha = False
    last = 100
    for _ in comp.file.frames:
        durations.append(last)
        last = comp.step().duration
        rgb, alpha = comp.output()
        if alpha is None:
            alpha = np.full(rgb.shape[:2], 255, np.uint8)
        any_alpha |= bool(alpha.min() < 255)
        frames.append(rgb)
        alphas.append(alpha)
    return Animation(frames=frames, alphas=alphas if any_alpha else None,
                     durations=durations, loop=comp.file.loop)
