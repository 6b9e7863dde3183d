"""Host codec layer: media sniffing, decode and encode.

The port's counterpart of ``flyimg_tpu/codecs``:

- PNG: ``codecs/png.py``, on zlib and numpy (every colour type, bit depth
  and interlace).
- JPEG: nvJPEG, the CUDA toolkit's codec, through ``ctypes``
  (``codecs/native_codec.py``): three-component (YCbCr), gray and Adobe
  CMYK/YCCK sources. It decodes and encodes on the card, so a JPEG needs
  a CUDA device: on the CPU it raises. The card machine has no
  libjpeg, so the reference's trellis encoder (``moz_1``) waits: ``moz_1``
  is optimized Huffman tables and progressive scans, as the JAX package's
  Pillow path encodes it.
- WebP: a lossy (VP8) and a lossless (VP8L) encoder and decoder written
  for this package (``codecs/native/``, built with g++ at first use into
  one library): the card machine has no libwebp. Lossy answers at ``q_``
  (alpha in a lossless ALPH chunk), lossless with ``webpl_1``; sources of
  either kind decode as libwebp's WebPDecodeRGB(A) decodes them, and an
  animated source as libwebp's WebPAnimDecoder composites it
  (``codecs/webp_anim.py``).
- GIF: ``codecs/gif.py`` decodes stills and every frame of an animation as
  Pillow composites them, and encodes stills and animations as Pillow's
  writer does (median-cut palette, LZW; the loops in ``codecs/native/``).
- BMP, ICO and TIFF sources: ``codecs/bmp.py``, ``codecs/ico.py`` and
  ``codecs/tiff.py``, as Pillow decodes them. The sniff copy reports an ICO
  or a TIFF as ``application/octet-stream`` (as the reference's does), so
  ``decode`` tells them by their magic.

Every decode applies the source's orientation (JPEG APP1, PNG eXIf, WebP
EXIF, TIFF tag 274), to the colour and the alpha plane alike, as the
reference's ``-auto-orient`` does. ``codecs/metadata.py`` carries a source's
EXIF, ICC profile and XMP into an ``st_0`` answer. CMYK JPEG output is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

from flyimg_tpu_torch.codecs import bmp, gif, ico, native_codec, png, tiff, webp_anim
from flyimg_tpu_torch.codecs.gif import Animation
from flyimg_tpu_torch.codecs.exif import apply_orientation, jpeg_orientation
from flyimg_tpu_torch.codecs.metadata import png_orientation, webp_orientation
from flyimg_tpu_torch.codecs.sniff import (
    BMP_MIME,
    GIF_MIME,
    JPEG_MIME,
    PNG_MIME,
    WEBP_MIME,
    MediaInfo,
    sniff,
)
from flyimg_tpu_torch.exceptions import (
    InvalidArgumentException,
    UnsupportedMediaException,
)


@dataclass
class DecodedImage:
    """Host-side decoded image: RAW rgb plus a separate alpha plane."""

    rgb: np.ndarray                      # [h, w, 3] uint8
    alpha: Optional[np.ndarray]          # [h, w] uint8 or None
    mime: str
    orig_size: Optional[Tuple[int, int]] = None  # (w, h) before any prescale
    n_frames: int = 1

    @property
    def size(self) -> Tuple[int, int]:
        return (self.rgb.shape[1], self.rgb.shape[0])


def media_info(data: bytes) -> MediaInfo:
    """Media type + dims from the leading bytes."""
    return sniff(data[:65536])


def _dct_scale_num(src_w: int, src_h: int, hint: Tuple[int, int]) -> int:
    """Smallest JPEG DCT scale (scale_num/8) that keeps the decoded image
    >= 2x the target box on both axes, so the device resample remains the
    quality-determining step."""
    tw, th = hint
    if not tw or not th or src_w <= 0 or src_h <= 0:
        return 8
    for scale_num in (1, 2, 4, 8):  # 1/8, 1/4, 1/2, 1/1
        if src_w * scale_num >= tw * 2 * 8 and src_h * scale_num >= th * 2 * 8:
            return scale_num
    return 8


def jpeg_batch_scale_num(data_info: MediaInfo, target_hint) -> int:
    """The DCT prescale numerator (of 8) a JPEG source decodes at for this
    target hint."""
    if target_hint and data_info.width and data_info.height:
        return _dct_scale_num(data_info.width, data_info.height, target_hint)
    return 8


def _split_alpha(pixels: np.ndarray, channels: int, mime: str) -> DecodedImage:
    """[h, w, 3|4] pixels -> DecodedImage with RAW rgb + a separate alpha
    plane (the contract every decode path shares)."""
    alpha = pixels[..., 3].copy() if channels == 4 else None
    rgb = np.ascontiguousarray(pixels[..., :3])
    return DecodedImage(rgb=rgb, alpha=alpha, mime=mime,
                        orig_size=(rgb.shape[1], rgb.shape[0]))


def _oriented(decoded: DecodedImage, orientation: int) -> DecodedImage:
    """``decoded`` turned upright, colour and alpha alike."""
    if orientation == 1:
        return decoded
    alpha = decoded.alpha
    if alpha is not None:
        alpha = np.ascontiguousarray(apply_orientation(alpha, orientation))
    return DecodedImage(
        rgb=np.ascontiguousarray(apply_orientation(decoded.rgb, orientation)),
        alpha=alpha, mime=decoded.mime, orig_size=decoded.orig_size,
        n_frames=decoded.n_frames,
    )


#: the MIME types Pillow names an ICO and a TIFF by (the sniff copy reports
#: both as application/octet-stream)
ICO_MIME = "image/x-icon"
TIFF_MIME = "image/tiff"


def source_mime(data: bytes, info: MediaInfo) -> str:
    """The decoder's MIME for ``data``: the sniffed one, or ICO and TIFF by
    their magic (the format Pillow would find)."""
    if info.mime == "application/octet-stream":
        if data[:4] == ico.MAGIC:
            return ICO_MIME
        if data[:4] in tiff.MAGICS:
            return TIFF_MIME
    return info.mime


def _decoded(rgb, alpha, mime: str, n_frames: int = 1) -> DecodedImage:
    return DecodedImage(rgb=rgb, alpha=alpha, mime=mime,
                        orig_size=(rgb.shape[1], rgb.shape[0]), n_frames=n_frames)


def decode(
    data: bytes,
    *,
    target_hint: Optional[Tuple[int, int]] = None,
    info: Optional[MediaInfo] = None,
    frame: int = 0,
    device: Union[str, "torch.device"] = "cuda",  # noqa: F821
) -> DecodedImage:
    """Decode bytes -> upright DecodedImage. A JPEG decodes on ``device``
    (nvJPEG; a CUDA device), prescaled by ``jpeg_batch_scale_num`` toward
    ``target_hint``; every other format decodes on the host. ``frame``
    picks the frame of an animated GIF or WebP, or the page of a TIFF
    (``min(frame, n_frames - 1)``, the reference's ``gf_``); ``n_frames``
    counts them. Pass ``info`` when the caller already probed the bytes."""
    info = info or media_info(data)
    mime = source_mime(data, info)
    if mime == JPEG_MIME:
        scale_num = jpeg_batch_scale_num(info, target_hint)
        rgb = native_codec.jpeg_decode(data, scale_num, device=device)
        decoded = DecodedImage(
            rgb=rgb, alpha=None, mime=JPEG_MIME,
            orig_size=(info.width or rgb.shape[1], info.height or rgb.shape[0]),
        )
        return _oriented(decoded, jpeg_orientation(data))
    if mime == PNG_MIME:
        rgb, alpha = png.decode(data)
        return _oriented(_decoded(rgb, alpha, PNG_MIME), png_orientation(data))
    if mime == WEBP_MIME:
        if webp_anim.is_animated(data):
            rgb, alpha, n = webp_anim.decode(data, frame)
            decoded = _decoded(rgb, alpha, WEBP_MIME, n)
        else:
            pixels, channels = native_codec.webp_decode_auto(data)
            decoded = _split_alpha(pixels, channels, WEBP_MIME)
        return _oriented(decoded, webp_orientation(data))
    if mime == GIF_MIME:
        rgb, alpha, n = gif.decode(data, frame)
        return _decoded(rgb, alpha, GIF_MIME, n)
    if mime == BMP_MIME:
        return _decoded(*bmp.decode(data), BMP_MIME)
    if mime == ICO_MIME:
        return _decoded(*ico.decode(data), ICO_MIME)
    if mime == TIFF_MIME:
        rgb, alpha, n = tiff.decode(data, frame)
        return _decoded(rgb, alpha, TIFF_MIME, n)
    raise UnsupportedMediaException(
        f"decoding {info.mime} is not ported to the PyTorch package yet "
        "(PNG, JPEG, WebP, GIF, BMP, ICO and TIFF only)"
    )


def decode_all(data: bytes, info: Optional[MediaInfo] = None) -> Animation:
    """Every frame of an animated GIF or WebP (or page of a TIFF),
    composited, with durations and loop, as the JAX handler's
    ``_decode_all_frames`` reads them through Pillow."""
    info = info or media_info(data)
    mime = source_mime(data, info)
    if mime == GIF_MIME:
        return gif.decode_all(data)
    if mime == WEBP_MIME and webp_anim.is_animated(data):
        return webp_anim.decode_all(data)
    if mime == TIFF_MIME:
        frames, alphas, any_alpha = [], [], False
        for page in range(tiff.n_frames(data)):
            rgb, alpha, _ = tiff.decode(data, page)
            alpha = alpha if alpha is not None else np.full(rgb.shape[:2], 255, np.uint8)
            any_alpha |= bool(alpha.min() < 255)
            frames.append(rgb)
            alphas.append(alpha)
        return Animation(frames=frames, alphas=alphas if any_alpha else None,
                         durations=[100] * len(frames), loop=None)
    raise UnsupportedMediaException(f"{mime} has no frames to animate")


#: IM ratio spellings -> luma (h, v) sampling factors. The geometry form
#: "HxV" is parsed directly; both grammars are what the reference forwards
#: verbatim to `-sampling-factor` (ImageProcessor.php:105, default 1x1 at
#: config/parameters.yml:102).
_SAMPLING_RATIOS = {
    "4:4:4": (1, 1),
    "4:2:2": (2, 1),
    "4:2:0": (2, 2),
    "4:4:0": (1, 2),
    "4:1:1": (4, 1),
    "4:1:0": (4, 2),
}


def parse_sampling_factor(value) -> Tuple[int, int]:
    """IM -sampling-factor grammar -> luma (h, v) factor pair. Accepts the
    geometry form ``HxV`` (1..4 each, h*v <= 8 per the JPEG MCU budget)
    and the ratio form ``4:2:0`` etc. Unparseable values raise — the
    reference would hand them to `convert`, which errors out
    (ExecFailedException); silent coercion to some other subsampling would
    change image content without telling the caller."""
    s = str(value if value is not None else "1x1").strip().lower()
    if not s:
        return (1, 1)
    if s in _SAMPLING_RATIOS:
        return _SAMPLING_RATIOS[s]
    parts = s.split("x")
    if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
        h, v = int(parts[0]), int(parts[1])
        if 1 <= h <= 4 and 1 <= v <= 4 and h * v <= 8:
            return (h, v)
    raise InvalidArgumentException(
        f"invalid sampling factor {value!r} (expected HxV with factors "
        "1..4, h*v <= 8, or a ratio like 4:2:0)"
    )


def require_encodable(fmt: str, *, sampling_factor: str = "1x1") -> None:
    """Raise UnsupportedMediaException where ``encode`` cannot write what
    the JAX package writes: JPEG sampling factors nvJPEG has no chroma
    subsampling for (1x3, 1x4, 2x3, 2x4, 3x1, 3x2). A sampling factor that
    does not parse raises InvalidArgumentException, as in ``encode``."""
    if fmt in ("jpg", "jpeg"):
        factors = parse_sampling_factor(sampling_factor)
        if factors not in native_codec.SAMPLINGS:
            raise UnsupportedMediaException(
                f"sampling factor {factors[0]}x{factors[1]} is not ported to "
                "the PyTorch package yet (nvJPEG has no chroma subsampling "
                "for it)"
            )


def encode(
    image: np.ndarray,
    fmt: str,
    alpha: Optional[np.ndarray] = None,
    *,
    quality: int = 90,
    webp_lossless: bool = False,
    mozjpeg: bool = True,
    sampling_factor: str = "1x1",
    device: Union[str, "torch.device"] = "cuda",  # noqa: F821
) -> bytes:
    """Encode [h, w, 3] uint8 (+ an optional [h, w] alpha plane) to ``fmt``
    bytes. ``jpg`` encodes on ``device`` (nvJPEG; ``mozjpeg`` selects
    optimized Huffman tables and progressive scans, ``sampling_factor`` the
    chroma subsampling); ``png``, ``webp`` and ``gif`` encode on the host,
    ``webp`` lossy at ``quality`` or lossless with ``webp_lossless``, ``gif``
    as Pillow writes an RGB frame (alpha is not written)
    (``require_encodable`` says what raises)."""
    require_encodable(fmt, sampling_factor=sampling_factor)
    if fmt == "png":
        return png.encode(image, alpha)
    if fmt == "webp":
        pixels = image if alpha is None else np.dstack([image, alpha])
        return native_codec.webp_encode(pixels, quality, lossless=bool(webp_lossless))
    if fmt == "gif":
        return gif.encode(image)
    if fmt in ("jpg", "jpeg"):  # no alpha plane in a JPEG
        return native_codec.jpeg_encode(
            image, quality, optimize=bool(mozjpeg), progressive=bool(mozjpeg),
            sampling=parse_sampling_factor(sampling_factor), device=device,
        )
    raise UnsupportedMediaException(
        f"encoding {fmt} is not ported to the PyTorch package yet "
        "(png, jpg, webp and gif only)"
    )


def encode_animation(frames, alphas=None, durations=None, loop=None) -> bytes:
    """Frames -> an animated GIF as the JAX handler's
    ``_encode_gif_animation`` writes it (``codecs/gif.py``)."""
    return gif.encode_animation(frames, alphas, durations, loop)
