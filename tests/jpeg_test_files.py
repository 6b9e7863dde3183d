"""JPEG files for the decoder's CPU tests, and the JAX package's native
decodes of them.

``encoder(tmp)`` compiles a small libjpeg encoder (g++ against the host's
``jpeglib.h``, into a temporary directory): any luma sampling factors,
baseline or progressive, with or without a restart interval, Huffman or
arithmetic coding (with DAC conditioning) -- layouts the JAX package's own
encoders do not write.
``Native`` binds the JAX package's ``fc_jpeg_decode`` and
``fc_jpeg_decode_roi`` from its unmodified ``fastcodec.cpp``, built by
``tests/jax_fastcodec.py``. The damage helpers cut a file or flip bytes
inside its entropy-coded data.
"""

import ctypes
import os
import subprocess

import numpy as np

_ENCODER_SRC = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <jpeglib.h>
extern "C" unsigned char* enc(const unsigned char* rgb, int w, int h, int q, int sh, int sv,
                               int progressive, int restart, int gray, int arith,
                               int dac, unsigned long* n) {
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  unsigned char* mem = nullptr;
  jpeg_mem_dest(&c, &mem, n);
  c.image_width = w;
  c.image_height = h;
  c.input_components = gray ? 1 : 3;
  c.in_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, q, TRUE);
  if (progressive) jpeg_simple_progression(&c);
  c.restart_interval = restart;
  c.arith_code = arith ? TRUE : FALSE;
  if (dac >= 0) {
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      c.arith_dc_L[t] = dac & 15;
      c.arith_dc_U[t] = (dac >> 4) & 15;
      c.arith_ac_K[t] = (dac >> 8) & 63;
    }
  }
  if (!gray) {
    c.comp_info[0].h_samp_factor = sh;
    c.comp_info[0].v_samp_factor = sv;
    for (int i = 1; i < 3; ++i) c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  }
  jpeg_start_compress(&c, TRUE);
  int stride = w * (gray ? 1 : 3);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(rgb + (size_t)c.next_scanline * stride);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return mem;
}
"""


class Encoder:
    """libjpeg's encoder with any sampling factors and restart interval."""

    def __init__(self, directory: str):
        src = os.path.join(directory, "enc.cpp")
        out = os.path.join(directory, "libtestenc.so")
        with open(src, "w") as fh:
            fh.write(_ENCODER_SRC)
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", out, src, "-ljpeg"],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(out)
        lib.enc.restype = ctypes.c_void_p
        i = ctypes.c_int
        lib.enc.argtypes = [ctypes.c_char_p, i, i, i, i, i, i, i, i, i, i,
                            ctypes.POINTER(ctypes.c_ulong)]
        self.lib = lib
        self.libc = ctypes.CDLL(None)
        self.libc.free.argtypes = [ctypes.c_void_p]

    def __call__(self, pixels: np.ndarray, quality: int = 90, sampling=(2, 2),
                 progressive: bool = False, restart: int = 0, arith: bool = False,
                 dac=None) -> bytes:
        """``dac``: arithmetic conditioning (L, U, Kx) for every table, which
        the encoder then writes in a DAC marker (None: libjpeg's defaults,
        no DAC)."""
        pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
        packed = -1 if dac is None else dac[0] | dac[1] << 4 | dac[2] << 8
        gray = pixels.ndim == 2
        h, w = pixels.shape[:2]
        n = ctypes.c_ulong()
        ptr = self.lib.enc(pixels.tobytes(), w, h, quality, sampling[0], sampling[1],
                           int(progressive), restart, int(gray), int(arith), packed,
                           ctypes.byref(n))
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self.libc.free(ptr)


def encoder(directory: str) -> Encoder:
    return Encoder(directory)


def _fixture_tool():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(root, "tools", "make_jpeg_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


#: the JAX package's native JPEG decodes (fc_jpeg_decode, fc_jpeg_decode_roi)
Native = _fixture_tool().NativeDecoder


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """A seeded photo-like image: smooth colour fields, edges and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (11.0 + 7 * c) + c) * np.cos(xx / (23.0 - 4 * c))
                    for c in range(3)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = (220.0, 40.0, 90.0)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def scan_start(data: bytes) -> int:
    """The offset of the first scan's entropy-coded data."""
    i = 2
    while i + 4 <= len(data):
        marker = data[i + 1]
        seglen = int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xDA:
            return i + 2 + seglen
        i += 2 + seglen
    raise ValueError("no scan")


def corrupt(data: bytes, seed: int, nbytes: int = 6) -> bytes:
    """``data`` with up to ``nbytes`` bytes after its first scan's start
    replaced by seeded values (no 0xFF byte or the byte after one is
    touched, so no marker appears or goes; in a progressive file the later
    scans' marker segments may be hit)."""
    rng = np.random.default_rng(seed)
    start = scan_start(data)
    buf = bytearray(data)
    for pos in rng.integers(start + 16, len(data) - 16, nbytes):
        if buf[pos] != 0xFF and buf[pos - 1] != 0xFF:
            buf[pos] = int(rng.integers(0, 255))
    return bytes(buf)


def truncate(data: bytes, fraction: float) -> bytes:
    """``data`` cut after ``fraction`` of its first scan's data."""
    start = scan_start(data)
    return data[:start + int((len(data) - start) * fraction)]
