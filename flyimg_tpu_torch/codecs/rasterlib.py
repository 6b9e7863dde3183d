"""ctypes bindings of the port's raster loops (``codecs/native/gif.cpp`` and
``codecs/native/raster.cpp``, built with g++ into one host library at first
use by ``cuda_build.load_host("raster")``): GIF and TIFF LZW, the GIF LZW
encoder, the median-cut quantizer, PackBits and BMP RLE. The containers
around them are read and written in Python (``gif.py``, ``tiff.py``,
``bmp.py``). A library that fails to build raises; nothing falls back."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.exceptions import ExecFailedException

_SIZE = ctypes.c_size_t


def _lib():
    lib = cuda_build.load_host("raster")
    if not getattr(lib, "_flyimg_bound", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.fl_gif_lzw_decode.restype = ctypes.c_long
        lib.fl_gif_lzw_decode.argtypes = [ctypes.c_char_p, _SIZE, i, p, _SIZE,
                                          ctypes.POINTER(i)]
        lib.fl_tiff_lzw_decode.restype = ctypes.c_long
        lib.fl_tiff_lzw_decode.argtypes = [ctypes.c_char_p, _SIZE, p, _SIZE,
                                           ctypes.POINTER(i)]
        lib.fl_gif_lzw_encode.restype = p
        lib.fl_gif_lzw_encode.argtypes = [p, _SIZE, i, ctypes.POINTER(_SIZE)]
        lib.fl_quantize.restype = i
        lib.fl_quantize.argtypes = [p, _SIZE, i, p, p]
        lib.fl_packbits_decode.restype = ctypes.c_long
        lib.fl_packbits_decode.argtypes = [ctypes.c_char_p, _SIZE, p, _SIZE]
        lib.fl_bmp_rle_decode.restype = p
        lib.fl_bmp_rle_decode.argtypes = [ctypes.c_char_p, _SIZE, _SIZE, i, i, i,
                                          ctypes.POINTER(_SIZE)]
        lib.fl_raster_free.restype = None
        lib.fl_raster_free.argtypes = [p]
        lib._flyimg_bound = True
    return lib


def _take(ptr: int, nbytes: int) -> bytes:
    """Copy a malloc'd buffer of the library and free it."""
    out = ctypes.string_at(ptr, nbytes)
    _lib().fl_raster_free(ptr)
    return out


def gif_lzw_decode(data: bytes, min_code_size: int, count: int) -> Tuple[np.ndarray, int]:
    """GIF LZW data (sub-blocks joined) -> (up to ``count`` indices, status):
    status 0 at the end code or a full frame, 1 when the data ran out, 2
    for a code outside the table."""
    out = np.zeros(count, np.uint8)
    status = ctypes.c_int()
    n = _lib().fl_gif_lzw_decode(data, len(data), int(min_code_size),
                                 out.ctypes.data, count, ctypes.byref(status))
    return out[:n], status.value


def tiff_lzw_decode(data: bytes, count: int) -> Tuple[np.ndarray, int]:
    """TIFF LZW -> (up to ``count`` bytes, status as ``gif_lzw_decode``; 3
    for the old-style bit order)."""
    out = np.zeros(count, np.uint8)
    status = ctypes.c_int()
    n = _lib().fl_tiff_lzw_decode(data, len(data), out.ctypes.data, count,
                                  ctypes.byref(status))
    return out[:n], status.value


def gif_lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """Palette indices -> GIF image data (code size byte, sub-blocks,
    terminator)."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    out_len = _SIZE()
    ptr = _lib().fl_gif_lzw_encode(idx.ctypes.data, idx.size, int(min_code_size),
                                   ctypes.byref(out_len))
    if not ptr:
        raise ExecFailedException("GIF LZW encode failed")
    return _take(ptr, out_len.value)


def quantize(rgb: np.ndarray, max_colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """[h, w, 3] uint8 -> (palette [n, 3] uint8, indices [h, w] uint8) by
    median cut, as Pillow's ``convert("P", palette=ADAPTIVE)``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    palette = np.zeros((256, 3), np.uint8)
    idx = np.zeros((h, w), np.uint8)
    n = _lib().fl_quantize(rgb.ctypes.data, h * w, int(max_colors),
                           palette.ctypes.data, idx.ctypes.data)
    if n <= 0:
        raise ExecFailedException("GIF quantize failed")
    return palette[:n].copy(), idx


def packbits_decode(data: bytes, count: int) -> np.ndarray:
    """PackBits -> up to ``count`` bytes."""
    out = np.zeros(count, np.uint8)
    n = _lib().fl_packbits_decode(data, len(data), out.ctypes.data, count)
    return out[:n]


def bmp_rle_decode(data: bytes, base: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """A BMP's RLE pixel data (from file offset ``base``) -> indices in file
    row order, as Pillow's decoder writes them (they may fall short of or
    run past w * h)."""
    out_len = _SIZE()
    ptr = _lib().fl_bmp_rle_decode(data, len(data), int(base), int(w), int(h),
                                   int(bool(rle4)), ctypes.byref(out_len))
    if not ptr:
        raise ExecFailedException("BMP RLE decode failed")
    return np.frombuffer(_take(ptr, out_len.value), np.uint8)
