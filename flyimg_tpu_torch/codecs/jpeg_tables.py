"""Constants of the port's JPEG encoder (``codecs/jpeg_enc.py``).

The package's own copy of the tables the JAX package's native encoder
uses (``fc_jpeg_encode_trellis`` in its ``fastcodec.cpp``) and of the
libjpeg defaults its ``fc_jpeg_encode`` and Pillow's CMYK save inherit:

- ``ZIGZAG``: zigzag position -> natural (row-major) index;
- ``LUMA_Q`` / ``CHROMA_Q``: the Annex K base quantization tables, and
  ``build_qtable``, IJG quality scaling with the force-baseline clamp
  (libjpeg's ``jpeg_set_quality(q, TRUE)``);
- the Annex K standard Huffman tables (``STD_HUFFMAN``), which a baseline
  encode without optimized tables writes;
- the trellis rate model: code lengths of the standard AC tables by
  (run, size) (``ac_code_bits``), its weight ``TRELLIS_ALPHA`` and
  ``trellis_params``, the float32 block of constants kernel K16 takes.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np

ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)

LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
)
CHROMA_Q = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
)

#: bits-to-distortion exchange rate of the trellis (the JAX package's
#: default; it reads an override from its environment, the port does not)
TRELLIS_ALPHA = 0.015


def build_qtable(quality: int, base) -> List[int]:
    """IJG quality scaling of a base table (natural order), each value
    clamped to 1..255 (force-baseline); quality clamped to 1..100."""
    quality = max(1, min(int(quality), 100))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return [max(1, min((b * scale + 50) // 100, 255)) for b in base]


def qtables(quality: int) -> Tuple[List[int], List[int]]:
    """(luma, chroma) quantization tables at ``quality``, natural order."""
    return build_qtable(quality, LUMA_Q), build_qtable(quality, CHROMA_Q)


# Annex K tables K.3-K.6: BITS[1..16] and HUFFVAL of each standard table
DC_LUMA_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_LUMA_VALS = tuple(range(12))
DC_CHROMA_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
DC_CHROMA_VALS = tuple(range(12))
AC_LUMA_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d)
AC_LUMA_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
)
AC_CHROMA_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
AC_CHROMA_VALS = (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
)


def _packed(bits, vals) -> bytes:
    """One table as the writer reads it: 16 BITS counts, then HUFFVAL,
    zero-padded to 256."""
    return bytes(bits) + bytes(vals) + bytes(256 - len(vals))


#: the four standard tables in the writer's order (DC 0, AC 0, DC 1,
#: AC 1), 272 bytes each
STD_HUFFMAN = b"".join((
    _packed(DC_LUMA_BITS, DC_LUMA_VALS), _packed(AC_LUMA_BITS, AC_LUMA_VALS),
    _packed(DC_CHROMA_BITS, DC_CHROMA_VALS), _packed(AC_CHROMA_BITS, AC_CHROMA_VALS),
))


def _code_lengths(bits, vals) -> Dict[int, int]:
    lengths, k = {}, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            lengths[vals[k]] = length
            k += 1
    return lengths


def ac_code_bits(chroma: bool) -> Tuple[np.ndarray, int, int]:
    """The trellis's rate proxy: code bits of the standard AC table for
    (run, size), [16, 11] (24 where the table has no code), and the EOB
    and ZRL code bits."""
    lengths = _code_lengths(*((AC_CHROMA_BITS, AC_CHROMA_VALS) if chroma
                              else (AC_LUMA_BITS, AC_LUMA_VALS)))
    table = np.zeros((16, 11), np.int32)
    for run in range(16):
        for size in range(1, 11):
            table[run, size] = lengths.get((run << 4) | size, 24)
    return table, lengths.get(0x00, 24), lengths.get(0xF0, 24)


def cos_table() -> np.ndarray:
    """[u, x] f32 basis of the orthonormal 8x8 DCT-II, computed in double
    and rounded once, as the JAX package's ``init_cos`` does."""
    out = np.zeros((8, 8), np.float32)
    for u in range(8):
        cu = math.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            out[u, x] = np.float32(cu * math.cos((2 * x + 1) * u * math.pi / 16.0))
    return out


#: float32 words of K16's constant block (csrc/jpeg_trellis.cu K16Params):
#: cos[8][8], q[2][64] (zigzag), lrate[2][11][16], lzrl[2], leob[2]
TRELLIS_PARAM_WORDS = 64 + 2 * 64 + 2 * 11 * 16 + 2 + 2


@functools.lru_cache(maxsize=None)
def trellis_params(quality: int) -> Dict[str, np.ndarray]:
    """The trellis's constants at ``quality``, every value float32 and
    computed in the JAX package's order: zigzag quantizers ``q`` [2, 64],
    lambda-weighted rates ``lrate`` [2, 11, 16] ([size][run]; size 0
    unused), ``lzrl`` [2], ``leob`` [2], and ``cos`` [8, 8]. Cached a
    quality, the arrays read-only."""
    f32 = np.float32
    q = np.zeros((2, 64), np.float32)
    lrate = np.zeros((2, 11, 16), np.float32)
    lzrl = np.zeros(2, np.float32)
    leob = np.zeros(2, np.float32)
    for t, nat in enumerate(qtables(quality)):
        q[t] = [nat[ZIGZAG[k]] for k in range(64)]
        acc = f32(0.0)
        for k in range(1, 64):
            acc = f32(acc + q[t, k])
        mean = f32(acc / f32(63.0))
        lam = f32(f32(f32(TRELLIS_ALPHA) * mean) * mean)
        table, eob, zrl = ac_code_bits(chroma=t == 1)
        for size in range(1, 11):
            for m in range(16):
                lrate[t, size, m] = f32(lam * f32(table[m, size] + size))
        lzrl[t] = f32(lam * f32(zrl))
        leob[t] = f32(lam * f32(eob))
    out = {"q": q, "lrate": lrate, "lzrl": lzrl, "leob": leob, "cos": cos_table()}
    for arr in out.values():
        arr.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def trellis_param_block(quality: int) -> np.ndarray:
    """``trellis_params`` packed in K16Params's layout (float32; cached,
    read only)."""
    p = trellis_params(quality)
    block = np.concatenate([p["cos"].ravel(), p["q"].ravel(), p["lrate"].ravel(),
                            p["lzrl"], p["leob"]]).astype(np.float32)
    if block.size != TRELLIS_PARAM_WORDS:
        raise RuntimeError(f"K16's constants are {block.size} words, not {TRELLIS_PARAM_WORDS}")
    block.setflags(write=False)
    return block
