"""ctypes bindings of the port's codecs: nvJPEG for JPEG, the package's own
VP8 and VP8L library for WebP.

The port's counterpart of ``flyimg_tpu/codecs/native_codec.py``, which
binds libjpeg and libwebp. The card machine has neither, so:

- JPEG goes through nvJPEG, the CUDA toolkit's codec (``libnvjpeg.so.12``),
  on the card: ``jpeg_decode`` decodes into device memory (Huffman decoding
  on the host, the IDCT and colour conversion on the card, chroma
  upsampled by interpolation), prescales there by a box mean over
  (8 / scale_num)^2 pixels with libjpeg's output size (the reference's
  DCT-domain prescale: nvJPEG's own scaling is the hardware decoder's
  only), and copies the pixels back; ``jpeg_encode`` copies the frame to
  the card, converts it to libjpeg's YCbCr planes there (``ycbcr_planes``:
  with nvJPEG's own RGB conversion its q90 encodes missed the JAX
  package's PSNR by more than 0.5 dB, PERF.md) and encodes them
  (baseline, or optimized Huffman tables with progressive scans). The
  reference's trellis encoder (``jpeg_encode_trellis``) is libjpeg code
  and waits.
- WebP goes through the package's own codec under ``codecs/native/``:
  ``webp_lossy.cpp`` (the VP8 encoder and decoder, the ALPH chunk and the
  container; its tables in ``vp8_tables.h``) and ``webp_lossless.cpp``
  (VP8L), compiled together with g++ into one library with a plain C
  interface at first use (``cuda_build.load_host``). An animated file is
  composited frame by frame in ``codecs/webp_anim.py``.

A library that is missing or fails to build raises; nothing falls back to
another codec. Handles are made at first use, never at import: the CPU tests
import every module on hosts without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import struct
import threading
from typing import List, Optional, Tuple, Union

import numpy as np

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

# ---------------------------------------------------------------------------
# nvJPEG
# ---------------------------------------------------------------------------

_NVJPEG_STATUS = {
    1: "not initialized", 2: "invalid parameter", 3: "bad JPEG",
    4: "JPEG not supported", 5: "allocator failure", 6: "execution failed",
    7: "arch mismatch", 8: "internal error", 9: "implementation not supported",
    10: "incomplete bitstream",
}
_BAD_JPEG, _NOT_SUPPORTED, _INCOMPLETE = 3, 4, 10
#: the most pixels a JPEG source may declare (the JAX package's Pillow
#: guard against decompression bombs); ``set_max_pixels`` re-bounds it
MAX_PIXELS = 512 * 1024 * 1024
#: nvjpegOutputFormat_t: the components' planes as coded, the luma plane,
#: interleaved RGB (all in the channels of one nvjpegImage_t)
_OUTPUT_UNCHANGED, _OUTPUT_Y, _OUTPUT_RGBI = 0, 2, 5
_BACKEND_DEFAULT = 0
#: chroma upsampled by interpolation, as libjpeg's fancy upsampling does
#: (replicated chroma puts 4:2:0 decodes tens of levels off libjpeg's)
_FLAGS_UPSAMPLING_WITH_INTERPOLATION = 1 << 5
_ENCODING_BASELINE = 0xC0
_ENCODING_PROGRESSIVE = 0xC2
#: luma (h, v) sampling factors -> nvjpegChromaSubsampling_t
_CSS = {(1, 1): 0, (2, 1): 1, (2, 2): 2, (1, 2): 3, (4, 1): 4, (4, 2): 5}
#: the luma (h, v) factor pairs ``jpeg_encode`` takes
SAMPLINGS = frozenset(_CSS)


class _NvjpegImage(ctypes.Structure):
    # nvjpegImage_t: NVJPEG_MAX_COMPONENT (4) planes
    _fields_ = [
        ("channel", ctypes.c_void_p * 4),
        ("pitch", ctypes.c_size_t * 4),
    ]


_nv_lock = threading.Lock()
_nv_lib = None
_nv_path = None
_nv_handles = {}          # device index -> nvjpegHandle_t
_nv_free = {}             # device index -> [(handle, dec, enc, params)]


def set_max_pixels(limit: int) -> None:
    """Re-bound ``MAX_PIXELS`` from the ``mem_max_source_pixels`` server
    parameter; 0 or less keeps the current bound (an unbounded decoder
    would defeat the guard)."""
    global MAX_PIXELS
    if int(limit) > 0:
        MAX_PIXELS = int(limit)


def _nvjpeg():
    global _nv_lib, _nv_path
    with _nv_lock:
        if _nv_lib is not None:
            return _nv_lib
        cands = ["libnvjpeg.so.12", "libnvjpeg.so"]
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cands += [os.path.join(home, "lib64", n) for n in cands]
        errors = []
        for cand in cands:
            try:
                lib = ctypes.CDLL(cand)
                _nv_path = cand
                break
            except OSError as exc:
                errors.append(str(exc))
        else:
            raise RuntimeError(
                "nvJPEG (libnvjpeg.so.12, the CUDA toolkit's) is not found: "
                + "; ".join(errors)
            )
        p, pp, i, ip, sz = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                            ctypes.c_size_t)
        img = ctypes.POINTER(_NvjpegImage)
        sigs = {
            "nvjpegGetProperty": [i, ip],
            "nvjpegCreateEx": [i, p, p, ctypes.c_uint, pp],
            "nvjpegJpegStateCreate": [p, pp],
            "nvjpegGetImageInfo": [p, ctypes.c_char_p, sz, ip, ip, ip, ip],
            "nvjpegDecode": [p, p, ctypes.c_char_p, sz, i, img, p],
            "nvjpegEncoderStateCreate": [p, pp, p],
            "nvjpegEncoderParamsCreate": [p, pp, p],
            "nvjpegEncoderParamsSetQuality": [p, i, p],
            "nvjpegEncoderParamsSetEncoding": [p, i, p],
            "nvjpegEncoderParamsSetOptimizedHuffman": [p, i, p],
            "nvjpegEncoderParamsSetSamplingFactors": [p, i, p],
            "nvjpegEncodeYUV": [p, p, p, img, i, i, i, p],
            "nvjpegEncodeRetrieveBitstream": [p, p, p, ctypes.POINTER(sz), p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _nv_lib = lib
        return lib


def _nv_check(status: int, what: str) -> None:
    if status == 0:
        return
    msg = f"nvJPEG {what}: {_NVJPEG_STATUS.get(status, status)}"
    if status == _NOT_SUPPORTED:
        raise UnsupportedMediaException(msg)
    if status in (_BAD_JPEG, _INCOMPLETE):
        raise ExecFailedException(msg)
    raise RuntimeError(msg)


def nvjpeg_path() -> str:
    """The name nvJPEG was loaded by."""
    _nvjpeg()
    return _nv_path


def nvjpeg_version() -> str:
    """nvJPEG's library version, major.minor.patch."""
    lib = _nvjpeg()
    parts = []
    for prop in range(3):
        v = ctypes.c_int()
        _nv_check(lib.nvjpegGetProperty(prop, ctypes.byref(v)), "version")
        parts.append(str(v.value))
    return ".".join(parts)


def _cuda_device(device):
    """``device`` as a CUDA torch.device, or an UnsupportedMediaException:
    nvJPEG codes only on a card."""
    import torch

    from flyimg_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise UnsupportedMediaException(
            "JPEG decoding and encoding run through nvJPEG on a CUDA device; "
            f"this call is on {dev}"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _nv_session(lib, index: int):
    """(handle, decode state, encoder state, encoder params) on card
    ``index`` for one call. The handle is shared; the states are not
    thread-safe, so a call borrows a set from the card's free list and
    gives it back (the server runs a thread a request: sets kept per thread
    would be made anew, and never freed, for every request)."""
    with _nv_lock:
        handle = _nv_handles.get(index)
        if handle is None:
            handle = ctypes.c_void_p()
            _nv_check(lib.nvjpegCreateEx(_BACKEND_DEFAULT, None, None,
                                         _FLAGS_UPSAMPLING_WITH_INTERPOLATION,
                                         ctypes.byref(handle)), "create")
            _nv_handles[index] = handle
        free = _nv_free.setdefault(index, [])
        mine = free.pop() if free else None
    if mine is None:
        dec, enc, params = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
        _nv_check(lib.nvjpegJpegStateCreate(handle, ctypes.byref(dec)), "state")
        _nv_check(lib.nvjpegEncoderStateCreate(handle, ctypes.byref(enc), None),
                  "encoder state")
        _nv_check(lib.nvjpegEncoderParamsCreate(handle, ctypes.byref(params), None),
                  "encoder params")
        mine = (handle, dec, enc, params)
    try:
        yield mine
    finally:
        with _nv_lock:
            _nv_free[index].append(mine)


#: start-of-frame markers (baseline, extended, progressive, lossless; the
#: arithmetic-coded ones too), whose segment lists the components
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_layout(data: bytes) -> Tuple[bool, Optional[int], List[Tuple[int, int, int]]]:
    """(a JFIF APP0 segment is present, the Adobe APP14 colour transform or
    None, [(component id, h, v) sampling factors] of the frame header): a
    marker walk up to the first scan."""
    jfif, transform, comps = False, None, []
    i, n = 2, len(data)
    while i + 4 <= n and data[i] == 0xFF:
        marker = data[i + 1]
        if marker in (0xDA, 0xD9):
            break
        (seglen,) = struct.unpack(">H", data[i + 2:i + 4])
        body = data[i + 4:i + 2 + seglen]
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and seglen >= 12 and len(body) >= 12:
            transform = body[11]
        elif marker in _SOF_MARKERS and len(body) >= 6:
            count = body[5]
            comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15)
                     for k in range(count) if 8 + 3 * k < len(body)]
        i += 2 + seglen
    return jfif, transform, comps


def adobe_transform(data: bytes) -> Optional[int]:
    """The colour transform of a JPEG's Adobe APP14 segment (0: none, CMYK
    or RGB as coded; 1: YCbCr; 2: YCCK), or None without one."""
    return jpeg_layout(data)[1]


def rgb_coded(jfif: bool, transform: Optional[int], comps) -> bool:
    """Whether a three-component JPEG of this ``jpeg_layout`` stores R, G, B
    as coded, as libjpeg decides it (jdapimin.c default_decompress_parms):
    never with JFIF; with an Adobe segment, transform 0; without either,
    component ids 'R', 'G', 'B'."""
    if len(comps) != 3 or jfif:
        return False
    if transform is not None:
        return transform == 0
    return [c[0] for c in comps] == [ord("R"), ord("G"), ord("B")]


def upsample_plane(plane, ratio: Tuple[int, int], out_hw: Tuple[int, int]):
    """One decoded component plane [h, w] uint8 (on any device) brought to
    the image's size as libjpeg-turbo's jdsample.c does, for the integer
    ``ratio`` (horizontal, vertical) of the largest sampling factors to the
    component's: 2:1 and 2:2 by its fancy (triangle) filters where the
    plane is more than 2 samples wide, 1:2 by its fancy filter, every other
    ratio by replication. Edges replicate (jdmainct.c's context rows),
    then the result is cut to ``out_hw``."""
    import torch

    hr, vr = (int(r) for r in ratio)
    x = plane.to(torch.int32)
    dh, dw = x.shape
    fancy_h = hr == 2 and dw > 2
    if (hr, vr) == (1, 1):
        out = x
    elif (hr, vr) == (2, 1) and fancy_h:
        left = torch.cat([x[:, :1], x[:, :-1]], 1)
        right = torch.cat([x[:, 1:], x[:, -1:]], 1)
        out = torch.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], -1)
        out = out.reshape(dh, 2 * dw)
    elif (hr, vr) in ((2, 2), (1, 2)) and (fancy_h or hr == 1):
        above = torch.cat([x[:1], x[:-1]], 0)
        below = torch.cat([x[1:], x[-1:]], 0)
        rows = []
        for near, bias in ((3 * x + above, 1), (3 * x + below, 2)):
            if hr == 1:
                rows.append((near + bias) >> 2)
                continue
            last = torch.cat([near[:, :1], near[:, :-1]], 1)
            nxt = torch.cat([near[:, 1:], near[:, -1:]], 1)
            rows.append(torch.stack([(3 * near + last + 8) >> 4,
                                     (3 * near + nxt + 7) >> 4], -1).reshape(dh, 2 * dw))
        out = torch.stack(rows, 1).reshape(2 * dh, -1)
    else:
        out = x.repeat_interleave(vr, 0).repeat_interleave(hr, 1)
    return out[: out_hw[0], : out_hw[1]].to(torch.uint8)


def cmyk_rgb(planes, ycck: bool):
    """The four decoded planes [4, h, w] uint8 of a CMYK or YCCK JPEG (as
    coded, on any device) -> [h, w, 3] uint8 RGB, as the JAX package's
    decode gives it: libjpeg's YCCK -> CMYK (jdcolor.c ycck_cmyk_convert,
    its fixed-point tables), then Pillow's Adobe polarity (the samples
    inverted, "CMYK;I") and its CMYK -> RGB (255 - K) - C (255 - K) / 255
    in integers."""
    import torch

    x = planes.to(torch.int32)
    if ycck:
        y, cb, cr = x[0], x[1] - 128, x[2] - 128
        half = 1 << 15
        r = y + ((_fix(1.40200) * cr + half) >> 16)
        g = y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + half) >> 16)
        b = y + ((_fix(1.77200) * cb + half) >> 16)
        x = torch.stack([(255 - v).clamp(0, 255) for v in (r, g, b)] + [x[3]])
    inv = 255 - x                       # Pillow reads CMYK;I
    nk = 255 - inv[3]
    t = inv[:3] * nk + 128
    rgb = (nk - (((t >> 8) + t) >> 8)).clamp(0, 255)
    return rgb.permute(1, 2, 0).to(torch.uint8)


def jpeg_decode(data: bytes, scale_num: int = 8,
                device: Union[str, "torch.device"] = "cuda") -> np.ndarray:  # noqa: F821
    """Decode JPEG bytes on the card -> [h, w, 3] uint8 on the host,
    prescaled to scale_num/8 (libjpeg's ceil(size * scale_num / 8)) on the
    card by a box mean of each (8 / scale_num)^2 block, rounded half up.
    Three YCbCr components decode to RGB in nvJPEG; one (gray) decodes its
    luma, repeated as Pillow's L -> RGB repeats it. The other layouts decode
    their components' planes as coded, each at its own size
    (``NVJPEG_OUTPUT_UNCHANGED``), upsampled to the image's size on the card
    as libjpeg does (``upsample_plane``, before any colour conversion):
    three RGB-coded components (``rgb_coded``) are the answer's R, G, B;
    four (Adobe CMYK or YCCK) are converted by ``cmyk_rgb``. A JPEG of
    another component count is refused."""
    import torch
    import torch.nn.functional as F

    dev = _cuda_device(device)
    lib = _nvjpeg()
    with torch.cuda.device(dev), _nv_session(lib, dev.index) as session:
        handle, state = session[:2]
        n_comp, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        _nv_check(lib.nvjpegGetImageInfo(handle, data, len(data), ctypes.byref(n_comp),
                                         ctypes.byref(css), widths, heights), "image info")
        w, h, n = widths[0], heights[0], n_comp.value
        if w * h > MAX_PIXELS:
            raise ExecFailedException(
                f"a {w}x{h} JPEG exceeds the {MAX_PIXELS}-pixel decode limit")
        if n not in (1, 3, 4):
            raise UnsupportedMediaException(
                f"a JPEG of {n} components is not ported to the PyTorch package")
        jfif, transform, comps = jpeg_layout(data)
        as_planes = n == 4 or (n == 3 and rgb_coded(jfif, transform, comps))
        image = _NvjpegImage()
        if as_planes:
            if len(comps) != n:
                raise ExecFailedException("the JPEG's frame header does not list its components")
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any(hmax % c[1] or vmax % c[2] for c in comps):
                # libjpeg refuses these too (JERR_FRACT_SAMPLE_NOTIMPL)
                raise UnsupportedMediaException(
                    f"a JPEG with fractional sampling ratios {comps} is not decodable")
            fmt = _OUTPUT_UNCHANGED
            planes = [torch.empty((heights[k], widths[k]), dtype=torch.uint8, device=dev)
                      for k in range(n)]
            targets = [(p, widths[k]) for k, p in enumerate(planes)]
        elif n == 3:
            out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
            fmt, targets = _OUTPUT_RGBI, [(out, w * 3)]
        else:
            luma = torch.empty((h, w), dtype=torch.uint8, device=dev)
            fmt, targets = _OUTPUT_Y, [(luma, w)]
        for k, (plane, pitch) in enumerate(targets):
            image.channel[k] = plane.data_ptr()
            image.pitch[k] = pitch
        stream = cuda_build.current_stream(dev.index)
        _nv_check(lib.nvjpegDecode(handle, state, data, len(data), fmt,
                                   ctypes.byref(image), stream), "decode")
        if n == 1:
            out = luma.unsqueeze(-1).expand(h, w, 3)
        elif as_planes:
            full = torch.stack([
                upsample_plane(p, (hmax // c[1], vmax // c[2]), (h, w))
                for p, c in zip(planes, comps)])
            if n == 3:
                out = full.permute(1, 2, 0)
            else:
                out = cmyk_rgb(full, ycck=transform is not None and transform != 0)
        if scale_num in (1, 2, 4):
            k = 8 // scale_num
            x = out.permute(2, 0, 1).unsqueeze(0).float()
            x = F.avg_pool2d(x, k, stride=k, ceil_mode=True)
            out = torch.floor(x + 0.5).to(torch.uint8)[0].permute(1, 2, 0)
        return out.contiguous().cpu().numpy()


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycbcr_planes(rgb, sampling: Tuple[int, int] = (1, 1)):
    """libjpeg's colour conversion and chroma downsampling of a [h, w, 3]
    uint8 tensor (on any device): (Y [h, w], Cb, Cr [ceil(h / v), ceil(w /
    h_)]) uint8, for luma sampling factors ``sampling`` = (h_, v). The
    arithmetic of jccolor.c's rgb_ycc_convert (16-bit fixed point) and
    jcsample.c's downsamplers: h2v1 and h2v2 with their alternating
    rounding biases, the rest a rounded mean; the right and bottom edges
    replicated."""
    import torch

    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    hf, vf = (int(f) for f in sampling)
    if (hf, vf) != (1, 1):
        h, w = y.shape
        ch, cw = -(-h // vf), -(-w // hf)
        rows = torch.arange(ch * vf, device=x.device).clamp_max(h - 1)
        cols = torch.arange(cw * hf, device=x.device).clamp_max(w - 1)
        odd = torch.arange(cw, device=x.device) % 2
        if (hf, vf) == (2, 1):
            bias = odd                      # 0, 1, 0, 1, ...
        elif (hf, vf) == (2, 2):
            bias = 1 + odd                  # 1, 2, 1, 2, ...
        else:
            bias = torch.full_like(odd, hf * vf // 2)
        shift = {1: 0, 2: 1, 4: 2, 8: 3}[hf * vf]
        cb, cr = ((c[rows][:, cols].reshape(ch, vf, cw, hf).sum((1, 3)) + bias) >> shift
                  for c in (cb, cr))
    return tuple(t.to(torch.uint8).contiguous() for t in (y, cb, cr))


def jpeg_encode(
    rgb: np.ndarray,
    quality: int = 90,
    *,
    optimize: bool = True,
    progressive: bool = True,
    sampling: Tuple[int, int] = (1, 1),
    device: Union[str, "torch.device"] = "cuda",  # noqa: F821
) -> bytes:
    """[h, w, 3] uint8 -> JPEG bytes, encoded on ``device``. ``sampling`` is
    the luma (h, v) factor pair (ImageMagick's -sampling-factor HxV):
    (1,1) = 4:4:4, (2,2) = 4:2:0, (2,1) = 4:2:2, (1,2) = 4:4:0, (4,1) =
    4:1:1, (4,2) = 4:1:0."""
    import torch

    dev = _cuda_device(device)
    sampling = tuple(int(f) for f in sampling)
    css = _CSS.get(sampling)
    if css is None:
        raise UnsupportedMediaException(
            f"nvJPEG has no chroma subsampling for factors {sampling}")
    lib = _nvjpeg()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    with torch.cuda.device(dev), _nv_session(lib, dev.index) as session:
        handle, _state, enc, params = session
        stream = cuda_build.current_stream(dev.index)
        planes = ycbcr_planes(torch.from_numpy(rgb).to(dev), sampling)
        image = _NvjpegImage()
        for k, plane in enumerate(planes):
            image.channel[k] = plane.data_ptr()
            image.pitch[k] = plane.shape[1]
        quality = max(1, min(int(quality), 100))
        _nv_check(lib.nvjpegEncoderParamsSetQuality(params, quality, stream), "quality")
        _nv_check(lib.nvjpegEncoderParamsSetEncoding(
            params, _ENCODING_PROGRESSIVE if progressive else _ENCODING_BASELINE, stream),
            "encoding")
        _nv_check(lib.nvjpegEncoderParamsSetOptimizedHuffman(params, int(optimize), stream),
                  "optimized Huffman")
        _nv_check(lib.nvjpegEncoderParamsSetSamplingFactors(params, css, stream),
                  "sampling factors")
        _nv_check(lib.nvjpegEncodeYUV(handle, enc, params, ctypes.byref(image), css, w, h,
                                      stream), "encode")
        length = ctypes.c_size_t()
        _nv_check(lib.nvjpegEncodeRetrieveBitstream(handle, enc, None,
                                                    ctypes.byref(length), stream),
                  "bitstream size")
        torch.cuda.current_stream(dev).synchronize()
        buf = ctypes.create_string_buffer(length.value)
        _nv_check(lib.nvjpegEncodeRetrieveBitstream(handle, enc, buf,
                                                    ctypes.byref(length), stream),
                  "bitstream")
        del planes
    return buf.raw[: length.value]


# ---------------------------------------------------------------------------
# WebP (VP8 and VP8L): codecs/native/webp_lossy.cpp and webp_lossless.cpp
# ---------------------------------------------------------------------------


def _webp():
    lib = cuda_build.load_host("webp")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fl_webp_encode.restype = p
        lib.fl_webp_encode.argtypes = [ctypes.c_char_p, i, i, i, i, i, i, i, i, i,
                                       ctypes.POINTER(ctypes.c_size_t)]
        lib.fl_webp_decode.restype = p
        lib.fl_webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(i), ctypes.POINTER(i),
                                       ctypes.POINTER(i), ctypes.POINTER(i),
                                       ctypes.POINTER(ctypes.c_char_p)]
        lib.fl_free.restype = None
        lib.fl_free.argtypes = [p]
        lib._flyimg_bound = True
    return lib


def _take_buffer(lib, ptr: int, nbytes: int) -> np.ndarray:
    buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    arr = np.frombuffer(buf, dtype=np.uint8).copy()
    lib.fl_free(ptr)
    return arr


def webp_encode(pixels: np.ndarray, quality: int = 90, lossless: bool = False, *,
                simple_filter: bool = False, sharpness: int = 0,
                partitions_log2: int = 0, mode_lf_delta: int = 0) -> bytes:
    """[h, w, 3|4] uint8 -> WebP: lossless (VP8L), or lossy (VP8) at
    ``quality`` 0-100. Alpha is stored when the layout carries it (a lossy
    file stores it losslessly in an ALPH chunk when a value is below 255).
    The keywords set the VP8 bitstream's options (the simple loop filter,
    its sharpness 0-7, 2**partitions_log2 token partitions, the filter
    level's delta for sub-block macroblocks); the service takes the
    defaults."""
    lib = _webp()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, channels = pixels.shape
    if channels not in (3, 4) or not (1 <= w <= 16383 and 1 <= h <= 16383):
        raise UnsupportedMediaException(
            f"WebP takes 1..16383 pixels a side and 3 or 4 channels, got {pixels.shape}")
    out_len = ctypes.c_size_t()
    ptr = lib.fl_webp_encode(pixels.tobytes(), w, h, channels,
                             max(0, min(int(quality), 100)), int(bool(lossless)),
                             int(bool(simple_filter)), int(sharpness), int(partitions_log2),
                             int(mode_lf_delta), ctypes.byref(out_len))
    if not ptr:
        raise ExecFailedException("WebP encode failed")
    return _take_buffer(lib, ptr, out_len.value).tobytes()


def webp_decode_auto(data: bytes) -> Tuple[np.ndarray, int]:
    """(pixels [h, w, ch] uint8, ch) with ch 4 iff the file carries alpha
    (as libwebp's WebPGetFeatures says). Lossy (VP8, with or without an
    ALPH chunk) and lossless (VP8L) files; an animation gives its first
    frame, composited as libwebp's WebPAnimDecoder does
    (``codecs/webp_anim.py``)."""
    lib = _webp()
    w, h, ch, status = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    reason = ctypes.c_char_p()
    ptr = lib.fl_webp_decode(data, len(data), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(ch), ctypes.byref(status), ctypes.byref(reason))
    if not ptr:
        if status.value == 2:
            from flyimg_tpu_torch.codecs import webp_anim

            rgb, alpha, _ = webp_anim.decode(data, 0)
            return (rgb, 3) if alpha is None else (np.dstack([rgb, alpha]), 4)
        raise ExecFailedException(f"WebP decode failed: {(reason.value or b'').decode()}")
    arr = _take_buffer(lib, ptr, w.value * h.value * ch.value)
    return arr.reshape(h.value, w.value, ch.value), ch.value
