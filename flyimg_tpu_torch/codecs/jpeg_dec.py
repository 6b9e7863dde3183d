"""The port's JPEG decoder: a host entropy decoder and two CUDA kernels.

The JAX package decodes JPEG with libjpeg-turbo (``fc_jpeg_decode`` and
``fc_jpeg_decode_roi`` in its native library): the islow IDCT, the reduced
IDCTs at DCT scales 1/2, 1/4 and 1/8, fancy upsampling and its integer
colour conversion. The port gives the same pixels, split three ways:

- ``codecs/native/jpeg_reader.cpp`` (g++, no libjpeg): markers and the
  Huffman decode (baseline, progressive, restarts, libjpeg-turbo's
  tolerance of damaged data and its block smoothing of a cut progressive
  file) into quantized coefficients, a batch of files on threads;
- kernel K18 (``csrc/jpeg_idct.cu``, ``idct_planes``): dequantization and
  the IDCT at each component's own output size, every block of every
  member of a batch in one launch, from a tile table built here (a row a
  CTA's run of blocks of one block row of one component window);
- kernel K19 (``csrc/jpeg_color.cu``, ``color_planes``): upsampling and
  colour conversion of every member's window to interleaved RGB, one
  launch, from a tile table of strips (a chroma row pair of one member by
  up to 512 columns).

The plain versions read the segment table (a row a component window: its
blocks, their output size and plane) and the member table; the tile tables
cut the same work for the kernels. A batch's tables go up to the card in
one copy from pinned memory beside the coefficients', and the wrappers take
every count from the host: nothing in the device half waits for the card.

On a CUDA device a kernel launches or raises; ``device="cpu"`` runs the
kernels' plain versions (``codecs/jpeg_dec_plain.py``), on CPU tensors
only.

The geometry is libjpeg-turbo's (jdmaster.c ``jpeg_core_output_dimensions``
and jdsample.c ``jinit_upsampler``): at 1/2 and 1/4 a subsampled
component is scaled up in its IDCT where the ratios allow (a 4:2:0 file's
chroma takes the 8x8 and 4x4 IDCT and is not upsampled), and a window
decode (``roi``) is ``fc_jpeg_decode_roi``'s: the window clamped to the
scaled frame, its left edge aligned down to the iMCU column and widened
(``jpeg_crop_scanline``), the upsampler seeing only the window's
component columns (so its edge columns replicate there, as libjpeg-turbo's
do), rows as a whole decode gives them, and a baseline file's entropy
decode stopped below the window.
"""

from __future__ import annotations

import ctypes
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.codecs import jpeg_dec_plain as plain
from flyimg_tpu_torch.codecs.jpeg_dec_plain import (
    MEM_FIELDS,
    MEM_H,
    MEM_W,
    MEM_Y0,
    SEG_BX0,
    SEG_BY0,
    SEG_COEF,
    SEG_FIELDS,
    SEG_GRID_W,
    SEG_NBX,
    SEG_NBY,
    SEG_OUT,
    SEG_PITCH,
    SEG_QT,
    SEG_SCALE,
    UP_FULL,
    UP_H1V2,
    UP_H2V1,
    UP_H2V2,
    UP_REPLICATE,
)
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

_Device = Union[str, torch.device]

#: jpeg_reader.cpp's return codes (2: a file libjpeg fails on)
_OK, _UNSUPPORTED = 0, 1


class FlJpegFrame(ctypes.Structure):
    # mirrors FlJpegFrame in codecs/native/jpeg_reader.cpp
    _fields_ = [(name, ctypes.c_int32) for name in (
        "width", "height", "ncomp", "progressive", "color", "adobe", "max_h", "max_v",
        "mcus_x", "mcus_y", "single_scan")] + [
        (name, ctypes.c_int32 * 4) for name in (
            "comp_id", "comp_h", "comp_v", "blocks_w", "blocks_h", "alloc_w", "alloc_h")] + [
        ("warnings", ctypes.c_int32), ("error", ctypes.c_char * 160)]


def _reader():
    lib = cuda_build.load_host("jpeg_reader")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        frame = ctypes.POINTER(FlJpegFrame)
        lib.fl_jpeg_header.argtypes = [ctypes.c_char_p, sz, frame]
        lib.fl_jpeg_header.restype = i
        lib.fl_jpeg_decode.argtypes = [ctypes.c_char_p, sz, frame, i, p, p, p]
        lib.fl_jpeg_decode.restype = i
        lib.fl_jpeg_decode_batch.argtypes = [i, p, p, frame, p, p, p, p, p, i]
        lib.fl_jpeg_decode_batch.restype = None
        lib._flyimg_bound = True
    return lib


def _raise_for(rc: int, frame: FlJpegFrame) -> None:
    why = frame.error.decode(errors="replace")
    if rc == _UNSUPPORTED:
        raise UnsupportedMediaException(f"JPEG decode: {why}")
    if rc != _OK:
        raise ExecFailedException(f"JPEG decode failed: {why}")


def read_header(data: bytes) -> FlJpegFrame:
    """The frame of a JPEG (markers up to its first scan); raises
    ``UnsupportedMediaException`` for what the port refuses by name
    (arithmetic coding, lossless, 12-bit) and ``ExecFailedException`` for
    what libjpeg fails on."""
    frame = FlJpegFrame()
    _raise_for(_reader().fl_jpeg_header(data, len(data), ctypes.byref(frame)), frame)
    return frame


# ---------------------------------------------------------------------------
# geometry (libjpeg-turbo's)
# ---------------------------------------------------------------------------

#: the DCT scales (of 8) the decode takes
SCALES = (1, 2, 4, 8)


@dataclass
class CompPlan:
    """One component of one member: its IDCT size and upsampling, and the
    block window K18 transforms into its plane."""

    ssize: int            # the component's DCT_scaled_size
    dw: int               # downsampled_width the upsampler sees
    dh: int               # downsampled_height (the bottom edge)
    method: int           # jpeg_dec_plain.UP_*
    hx: int               # replication factors (UP_REPLICATE)
    vx: int
    bx0: int = 0
    by0: int = 0
    nbx: int = 0
    nby: int = 0


@dataclass
class MemberPlan:
    """One member of a batch: the output window and each component's plan."""

    frame: FlJpegFrame
    full_w: int
    full_h: int
    x0: int               # the window (the whole frame without a roi)
    y0: int
    w: int
    h: int
    comps: List[CompPlan] = field(default_factory=list)
    max_mcu_rows: int = -1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _upsample_method(h_in: int, v_in: int, h_out: int, v_out: int, dw: int,
                     fancy: bool) -> Tuple[int, int, int]:
    """jdsample.c jinit_upsampler's choice for one component."""
    if h_in == h_out and v_in == v_out:
        return UP_FULL, 1, 1
    if h_in * 2 == h_out and v_in == v_out:
        return (UP_H2V1, 1, 1) if fancy and dw > 2 else (UP_REPLICATE, 2, 1)
    if h_in == h_out and v_in * 2 == v_out and fancy:
        return UP_H1V2, 1, 1
    if h_in * 2 == h_out and v_in * 2 == v_out:
        return (UP_H2V2, 1, 1) if fancy and dw > 2 else (UP_REPLICATE, 2, 2)
    if h_out % h_in == 0 and v_out % v_in == 0:
        return UP_REPLICATE, h_out // h_in, v_out // v_in
    raise ExecFailedException(
        "JPEG decode failed: fractional sampling factors are not supported")


def plan_member(frame: FlJpegFrame, scale_num: int,
                roi: Optional[Tuple[int, int, int, int]] = None) -> Optional[MemberPlan]:
    """The decode of ``frame`` at ``scale_num``/8, whole or the window
    ``roi`` = (x, y, w, h) in scaled-frame pixels as ``fc_jpeg_decode_roi``
    takes it. None when the window is empty after clamping (that call
    fails then)."""
    if scale_num not in SCALES:
        raise ValueError(f"scale_num must be one of {SCALES}, got {scale_num}")
    W, H, n = frame.width, frame.height, frame.ncomp
    max_h, max_v = frame.max_h, frame.max_v
    mins = scale_num
    fw, fh = _ceil_div(W * mins, 8), _ceil_div(H * mins, 8)
    ssizes, dws, dhs = [], [], []
    for c in range(n):
        h, v = frame.comp_h[c], frame.comp_v[c]
        s = mins
        while s < 8 and (max_h * mins) % (h * s * 2) == 0 and (max_v * mins) % (v * s * 2) == 0:
            s *= 2
        ssizes.append(s)
        dws.append(_ceil_div(W * h * s, max_h * 8))
        dhs.append(_ceil_div(H * v * s, max_v * 8))
    x0, y0, w, hh = 0, 0, fw, fh
    up_dws = list(dws)
    if roi is not None:
        rx, ry, rw, rh = (int(v) for v in roi)
        if rx < 0:
            rw += rx
            rx = 0
        if ry < 0:
            rh += ry
            ry = 0
        if rx + rw > fw:
            rw = fw - rx
        if ry + rh > fh:
            rh = fh - ry
        if rw <= 0 or rh <= 0 or rx >= fw or ry >= fh:
            return None
        x0, y0, w, hh = rx, ry, rw, rh
        if x0 != 0 or w != fw:
            # jpeg_crop_scanline
            align = mins if n == 1 else mins * max_h
            ax = (x0 // align) * align
            w = w + x0 - ax
            x0 = ax
            crop = [_ceil_div(w * frame.comp_h[c], max_h) for c in range(n)]
            if any(crop[c] < 2 <= dws[c] for c in range(n)):
                # jinit_upsampler runs again, on the cropped widths
                up_dws = crop
            dws = crop
    comps = []
    fancy = mins > 1
    for c in range(n):
        h, v, s = frame.comp_h[c], frame.comp_v[c], ssizes[c]
        h_in, v_in = h * s // mins, v * s // mins
        method, hx, vx = _upsample_method(h_in, v_in, max_h, max_v, up_dws[c], fancy)
        comps.append(CompPlan(ssize=s, dw=dws[c], dh=dhs[c], method=method, hx=hx, vx=vx))
    plan = MemberPlan(frame=frame, full_w=fw, full_h=fh, x0=x0, y0=y0, w=w, h=hh,
                      comps=comps)
    mcu_rows = 0
    for c, cp in enumerate(comps):
        h_in = frame.comp_h[c] * cp.ssize // mins
        v_in = frame.comp_v[c] * cp.ssize // mins
        cx0 = x0 * h_in // max_h
        if cp.method == UP_FULL:
            ncols = _ceil_div(w * h_in, max_h)
        elif cp.method == UP_REPLICATE:
            ncols = _ceil_div(w, cp.hx)
        else:
            ncols = cp.dw
        if cp.method in (UP_FULL, UP_H2V1):
            r0, r1 = y0, y0 + hh - 1
        elif cp.method == UP_REPLICATE:
            r0, r1 = y0 // cp.vx, (y0 + hh - 1) // cp.vx
        else:
            r0 = max(0, y0 // 2 - 1)
            r1 = min(cp.dh - 1, (y0 + hh - 1) // 2 + 1)
        bw, bh = frame.blocks_w[c], frame.blocks_h[c]
        cp.bx0 = cx0 // cp.ssize
        cp.nbx = max(1, min(_ceil_div(cx0 + ncols, cp.ssize), bw) - cp.bx0)
        cp.by0 = min(r0 // cp.ssize, bh - 1)
        cp.nby = max(1, min(r1 // cp.ssize, bh - 1) - cp.by0 + 1)
        last = cp.by0 + cp.nby       # block rows the entropy decode must reach
        mcu_rows = max(mcu_rows, last if n == 1 else _ceil_div(last, frame.comp_v[c]))
    if roi is not None and frame.single_scan:
        plan.max_mcu_rows = mcu_rows
    return plan


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _idct_lib():
    lib = cuda_build.load("jpeg_idct")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flyimg_jpeg_idct.argtypes = [p, p, p, i, p, p]
        lib.flyimg_jpeg_idct.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


def _color_lib():
    lib = cuda_build.load("jpeg_color")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flyimg_jpeg_color.argtypes = [p, p, p, i, p, p]
        lib.flyimg_jpeg_color.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


def _check_tiles(tiles: torch.Tensor, words: int, dev: torch.device, what: str) -> None:
    if tiles.device != dev or tiles.dtype != torch.int32 or tiles.dim() != 2 \
            or tiles.shape[1] != words or not tiles.is_contiguous() or tiles.shape[0] < 1:
        raise ValueError(f"{what}: tiles must be a contiguous int32 [n >= 1, {words}] tensor "
                         f"on {dev}, got {tuple(tiles.shape)} {tiles.dtype} on {tiles.device}")


def idct_planes(coefs: torch.Tensor, quant: torch.Tensor, table: torch.Tensor,
                plane_bytes: int) -> torch.Tensor:
    """Every segment's blocks dequantized and transformed into its plane:
    kernel K18 in one launch on CUDA tensors, ``table`` its tile table
    (int32 [n, 8], ``idct_tiles`` rows, on the card);
    ``jpeg_dec_plain.k18`` on CPU tensors, ``table`` the segment table
    (int64 [n, SEG_FIELDS]). ``coefs`` int16 [blocks * 64] (natural
    order), ``quant`` int32 [tables * 64] -> uint8 [plane_bytes] (on a
    card rounded up to 16 bytes, which K19's staged reads may reach)."""
    if coefs.device.type == "cpu":
        return plain.k18(coefs, quant, table, plane_bytes)
    if coefs.device.type != "cuda":
        raise ValueError(f"unsupported device {coefs.device}")
    tiles = table
    _check_tiles(tiles, IDCT_TILE.itemsize // 4, coefs.device, "jpeg_idct")
    out = torch.empty(_ceil_div(max(plane_bytes, 1), 16) * 16, dtype=torch.uint8,
                      device=coefs.device)
    rc = _idct_lib().flyimg_jpeg_idct(
        coefs.data_ptr(), quant.data_ptr(), tiles.data_ptr(), int(tiles.shape[0]),
        out.data_ptr(), cuda_build.current_stream(coefs.device.index))
    cuda_build.check(rc, "jpeg_idct")
    idct_planes.launches += 1
    return out


#: K18 launches since the last reset (a plain integer)
idct_planes.launches = 0


def color_planes(planes: torch.Tensor, members: torch.Tensor, out_bytes: int,
                 tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every member's window upsampled and colour-converted to interleaved
    RGB: kernel K19 in one launch on CUDA tensors (``planes`` from
    ``idct_planes``; ``tiles`` its strips, int32 [n, 4], ``color_tiles``
    rows, on the card), ``jpeg_dec_plain.k19`` on CPU tensors (no tiles).
    ``members`` int64 [m, MEM_FIELDS] -> uint8 [out_bytes]."""
    if planes.device.type == "cpu":
        return plain.k19(planes, members, out_bytes)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if tiles is None:
        raise ValueError("jpeg_color: a launch on the card needs the tile table")
    _check_tiles(tiles, COLOR_TILE.itemsize // 4, planes.device, "jpeg_color")
    if members.device != planes.device or members.dtype != torch.int64 \
            or not members.is_contiguous():
        raise ValueError("jpeg_color: members must be a contiguous int64 tensor on the card")
    out = torch.empty(max(out_bytes, 1), dtype=torch.uint8, device=planes.device)
    rc = _color_lib().flyimg_jpeg_color(
        planes.data_ptr(), members.data_ptr(), tiles.data_ptr(), int(tiles.shape[0]),
        out.data_ptr(), cuda_build.current_stream(planes.device.index))
    cuda_build.check(rc, "jpeg_color")
    color_planes.launches += 1
    return out


#: K19 launches since the last reset (a plain integer)
color_planes.launches = 0


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


def coef_count(frame: FlJpegFrame) -> int:
    """int16 coefficients ``fl_jpeg_decode`` writes for ``frame``."""
    return sum(frame.alloc_w[c] * frame.alloc_h[c] * 64 for c in range(frame.ncomp))


#: a K18 tile's blocks at most (csrc/jpeg_idct.cu kTile)
IDCT_TILE_BLOCKS = 64
#: a K19 strip's columns at most (csrc/jpeg_color.cu kMaxCols: 64 threads
#: a row of 8 pixels)
COLOR_STRIP_COLS = 512
#: a row of K18's tile table (csrc/jpeg_idct.cu K18Tile): a run of ``n``
#: blocks of one block row of one segment, from block ``coef`` of the
#: coefficient buffer to byte ``out`` of the planes
IDCT_TILE = np.dtype([("coef", "<i8"), ("out", "<i8"), ("pitch", "<i4"), ("n", "<i4"),
                      ("scale", "<i4"), ("qt", "<i4")])
#: a row of K19's tile table (csrc/jpeg_color.cu K19Tile): frame rows
#: ``y``.. of one chroma row pair (one row at a window's odd edge) by window
#: columns ``x0``..``x0 + nw - 1`` of one member
COLOR_TILE = np.dtype([("member", "<i4"), ("y", "<i4"), ("x0", "<i4"), ("nw", "<i4")])


def idct_tile_blocks(blocks: int) -> int:
    """K18's tile length for a batch of ``blocks``: 16 below 2^13 blocks,
    32 below 2^15, IDCT_TILE_BLOCKS from there. A small batch's shorter
    tiles spread its few blocks over more of the card's SMs; a large one's
    longer tiles cost fewer tile rounds a CTA. On an H100 this was the
    fastest of 16, 32 and 64, or within 5 % of it, at every 4:2:0 size
    timed from 300x250 to 4032x3024, at 1/4 and 1/1 (PERF.md §6)."""
    for length, least in ((IDCT_TILE_BLOCKS, 1 << 15), (32, 1 << 13)):
        if blocks >= least:
            return length
    return 16


def _runs(n: np.ndarray, most: int, unit) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each of ``n`` (>= 1) cut into the fewest runs of at most ``most`` (a
    multiple of ``unit``), each but the last a multiple of ``unit`` of
    near-equal length: (runs, their width, the last one's)."""
    per = -(-n // most)
    width = unit * -(-(-(-n // per)) // unit)
    return per, width, n - width * (per - 1)


def _cut(rows: np.ndarray, per: np.ndarray):
    """Item i's ``rows[i]`` rows of ``per[i]`` runs each, as tiles in item
    order: (spread, r, k), ``spread(v)`` an array of one value an item
    spread over its tiles, ``r`` and ``k`` each tile's row and run."""
    count = rows * per

    def spread(v):
        return np.repeat(v, count)

    r, k = np.divmod(np.arange(int(count.sum())) - spread(np.cumsum(count) - count), spread(per))
    return spread, r, k


def idct_tiles(segments: np.ndarray, most: Optional[int] = None) -> np.ndarray:
    """K18's tile table for a segment table (int64 [n, SEG_FIELDS]): each
    block row of each segment cut into runs of at most ``most`` blocks (by
    default ``idct_tile_blocks`` of the batch's blocks), each but a row's
    last 16 samples wide or a multiple of that (so that a row starting on a
    16-byte boundary keeps its tiles' rows on one), in segment order."""
    s = np.asarray(segments, np.int64).reshape(-1, SEG_FIELDS)
    nbx, scale, pitch = s[:, SEG_NBX], s[:, SEG_SCALE], s[:, SEG_PITCH]
    if most is None:
        most = idct_tile_blocks(int((nbx * s[:, SEG_NBY]).sum()))
    per, width, last = _runs(nbx, most, np.maximum(1, 16 // scale))
    spread, by, k = _cut(s[:, SEG_NBY], per)
    x = k * spread(width)
    n = np.where(k == spread(per) - 1, spread(last), spread(width))
    # IDCT_TILE's fields as four int64 words: coef, out, pitch | n << 32,
    # scale | qt << 32
    t = np.empty((len(k), 4), np.int64)
    t[:, 0] = spread(s[:, SEG_COEF] + s[:, SEG_BY0] * s[:, SEG_GRID_W] + s[:, SEG_BX0]) \
        + by * spread(s[:, SEG_GRID_W]) + x
    t[:, 1] = spread(s[:, SEG_OUT]) + (by * spread(pitch) + x) * spread(scale)
    t[:, 2] = spread(pitch) | (n << 32)
    t[:, 3] = spread(scale | (s[:, SEG_QT] << 32))
    return t.view(IDCT_TILE).reshape(-1)


def color_tiles(members: np.ndarray) -> np.ndarray:
    """K19's tile table for a member table (int64 [m, MEM_FIELDS]): each
    member's window cut into strips of its frame rows' chroma row pairs
    (the window's first row alone where it is odd) by runs of at most
    COLOR_STRIP_COLS columns, each but the last a multiple of 16 (48
    bytes of RGB: a row starting on a 16-byte boundary keeps its strips on
    one), in member order."""
    m = np.asarray(members, np.int64).reshape(-1, MEM_FIELDS)
    w, h, y0 = m[:, MEM_W], m[:, MEM_H], m[:, MEM_Y0]
    odd = y0 & 1
    per, width, last = _runs(np.maximum(w, 1), COLOR_STRIP_COLS, 16)
    spread, r, k = _cut(np.where((w > 0) & (h > 0), odd + (h - odd + 1) // 2, 0), per)
    t = np.empty((len(k), 4), np.int32)
    t[:, 0] = spread(np.arange(len(m)))
    t[:, 1] = spread(y0) + np.maximum(2 * r - spread(odd), 0)
    t[:, 2] = k * spread(width)
    t[:, 3] = np.where(k == spread(per) - 1, spread(last), spread(width))
    return t.view(COLOR_TILE).reshape(-1)


class Tables(NamedTuple):
    """What ``build_tables`` gives a batch."""

    segments: torch.Tensor      # int64 [n, SEG_FIELDS]: the plain K18's table
    members: torch.Tensor       # int64 [m, MEM_FIELDS]: K19's and its plain version's
    plane_bytes: int
    out_bytes: int
    outs: List[Tuple[int, int, int]]
    idct_tiles: np.ndarray      # IDCT_TILE rows: K18's tiles
    color_tiles: np.ndarray     # COLOR_TILE rows: K19's strips
    blocks: int                 # the blocks K18 transforms
    pixels: int                 # the pixels K19 makes


def build_tables(plans: Sequence[MemberPlan], coef_starts: Sequence[int]) -> Tables:
    """The kernels' tables for ``plans``, member i's coefficients starting
    at block ``coef_starts[i]`` of the batch's buffer and its quantization
    tables at table 4 * i: the segment and member tables, the plane and
    output bytes, each member's (output offset, w, h), K18's and K19's
    tile tables and the totals. The offsets are 64-bit: a group of large
    frames passes 2^31 bytes of planes or output."""
    segs, mems, outs = [], [], []
    plane_off = first_block = out_off = first_px = 0
    for i, pl in enumerate(plans):
        fr = pl.frame
        mem = np.zeros(MEM_FIELDS, np.int64)
        mem[:8] = [out_off, pl.w, pl.h, pl.y0, fr.color, int(fr.adobe or fr.color == 4),
                   fr.ncomp, first_px]
        block = coef_starts[i]
        for c, cp in enumerate(pl.comps):
            pitch = cp.nbx * cp.ssize
            seg = [block, fr.alloc_w[c], cp.bx0, cp.by0, cp.nbx, cp.nby, cp.ssize,
                   4 * i + c, plane_off, pitch, first_block, 0]
            segs.append(seg)
            mem[8 + 8 * c:16 + 8 * c] = [plane_off, pitch, cp.by0 * cp.ssize, cp.dw, cp.dh,
                                         cp.method, cp.hx, cp.vx]
            plane_off += pitch * cp.nby * cp.ssize
            first_block += cp.nbx * cp.nby
            block += fr.alloc_w[c] * fr.alloc_h[c]
        mems.append(mem)
        outs.append((out_off, pl.w, pl.h))
        out_off += pl.w * pl.h * 3
        first_px += pl.w * pl.h
    seg_rows = np.array(segs, np.int64).reshape(-1, SEG_FIELDS)
    mem_rows = np.array(mems, np.int64).reshape(-1, MEM_FIELDS)
    return Tables(torch.from_numpy(seg_rows), torch.from_numpy(mem_rows), plane_off, out_off,
                  outs, idct_tiles(seg_rows), color_tiles(mem_rows),
                  first_block, first_px)


@dataclass
class TableLayout:
    """Where each table lies in a batch's table buffer: (byte offset,
    rows)."""

    quant: Tuple[int, int]
    idct_tiles: Tuple[int, int]
    color_tiles: Tuple[int, int]
    members: Tuple[int, int]


def pack_tables(quant: np.ndarray, tables: Tables, pinned: bool):
    """The quantization tables (int32 [t, 64]), K18's and K19's tile tables
    and the member table in one uint8 buffer (pinned where ``pinned``),
    each at a 16-byte boundary: (buffer, TableLayout)."""
    parts = [np.ascontiguousarray(quant, np.int32), tables.idct_tiles, tables.color_tiles,
             tables.members.numpy()]
    offsets, off = [], 0
    for part in parts:
        offsets.append(off)
        off += _ceil_div(part.nbytes, 16) * 16
    buf = torch.empty(max(off, 16), dtype=torch.uint8, pin_memory=pinned)
    raw = buf.numpy()
    for part, start in zip(parts, offsets):
        raw[start:start + part.nbytes] = np.frombuffer(part.tobytes(), np.uint8)
    rows = [int(quant.shape[0]), len(tables.idct_tiles), len(tables.color_tiles),
            int(tables.members.shape[0])]
    return buf, TableLayout(*zip(offsets, rows))


def table_views(buf: torch.Tensor, layout: TableLayout):
    """(quant int32 [t * 64], K18's tiles int32 [n, 8], K19's tiles int32
    [n, 4], members int64 [m, MEM_FIELDS]) as views of a table buffer on
    any device."""

    def view(part, dtype, width, itemsize):
        off, rows = part
        return buf[off:off + rows * width * itemsize].view(dtype).reshape(rows, width)

    return (view(layout.quant, torch.int32, 64, 4).reshape(-1),
            view(layout.idct_tiles, torch.int32, IDCT_TILE.itemsize // 4, 4),
            view(layout.color_tiles, torch.int32, COLOR_TILE.itemsize // 4, 4),
            view(layout.members, torch.int64, MEM_FIELDS, 8))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

#: the most threads one batch's entropy decode runs on
MAX_THREADS = max(1, min(8, os.cpu_count() or 1))


@dataclass
class Decoded:
    """One member's result: the window's RGB, its origin and the scaled
    frame's size (the origin is (0, 0) and the size the window's for a
    whole-frame decode)."""

    rgb: np.ndarray
    offset: Tuple[int, int]
    frame_size: Tuple[int, int]


def _device(device: _Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class Batch:
    """A batch after its host entropy decode, ready for the kernels: each
    item's result so far (None, or the exception that member raised), the
    members that go on (``order``, their plans) and the kernels' inputs on
    the host: the coefficients, the quantization tables, ``build_tables``'
    tables, and ``pack_tables``' buffer of what goes to a card."""

    results: List[object]
    order: List[int]
    plans: Dict[int, MemberPlan]
    coefs: torch.Tensor          # int16, pinned where the batch goes to a card
    quant: torch.Tensor          # int32 [4 * members * 64]
    tables: Tables
    packed: torch.Tensor         # uint8: quant, K18's and K19's tiles, members (pinned so)
    layout: TableLayout


def entropy_decode(items: Sequence[Tuple[bytes, int, Optional[Tuple[int, int, int, int]]]],
                   pinned: bool = False, max_pixels: Optional[int] = None,
                   split: Optional[Dict[str, float]] = None) -> Batch:
    """The host half of ``decode_batch``: headers, plans and the entropy
    decode of every member on threads, then the kernels' tables. ``split``,
    when given, receives the seconds of the tables' step (``build_tables``
    and ``pack_tables``) as ``tables``."""
    lib = _reader()
    results: List[object] = [None] * len(items)
    plans: Dict[int, MemberPlan] = {}
    for i, (data, scale_num, roi) in enumerate(items):
        try:
            frame = read_header(data)
            if max_pixels is not None and frame.width * frame.height > max_pixels:
                raise ExecFailedException(
                    f"a {frame.width}x{frame.height} JPEG exceeds the {max_pixels}-pixel "
                    "decode limit")
            if frame.color < 0:
                raise ExecFailedException(
                    f"JPEG decode failed: a JPEG of {frame.ncomp} components has no RGB "
                    "conversion")
            plan = plan_member(frame, int(scale_num), roi)
            if plan is not None:
                plans[i] = plan
        except Exception as exc:  # noqa: BLE001 - the member's own failure
            results[i] = exc
    order = sorted(plans)
    counts = [coef_count(plans[i].frame) for i in order]
    coefs = torch.empty(max(sum(counts), 1), dtype=torch.int16, pin_memory=pinned)
    q16 = np.zeros((max(len(order), 1) * 4, 64), np.uint16)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64) if order else []
    if order:
        n = len(order)
        frames = (FlJpegFrame * n)()
        for k, i in enumerate(order):
            frames[k] = plans[i].frame
        datas = [items[i][0] for i in order]
        bufs = (ctypes.c_char_p * n)(*datas)
        lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
        rows = (ctypes.c_int * n)(*[plans[i].max_mcu_rows for i in order])
        # each component's first block column (block smoothing's left edge)
        first = (ctypes.c_int * (4 * n))(*[
            v for i in order for v in ([cp.bx0 for cp in plans[i].comps] + [0, 0, 0, 0])[:4]])
        cptr = (ctypes.c_void_p * n)(*[coefs.data_ptr() + 2 * int(s) for s in starts])
        qptr = (ctypes.c_void_p * n)(*[q16.ctypes.data + k * 4 * 64 * 2 for k in range(n)])
        rcs = (ctypes.c_int * n)()
        lib.fl_jpeg_decode_batch(n, ctypes.cast(bufs, ctypes.c_void_p),
                                 ctypes.cast(lens, ctypes.c_void_p), frames,
                                 ctypes.cast(rows, ctypes.c_void_p),
                                 ctypes.cast(first, ctypes.c_void_p),
                                 ctypes.cast(cptr, ctypes.c_void_p),
                                 ctypes.cast(qptr, ctypes.c_void_p),
                                 ctypes.cast(rcs, ctypes.c_void_p), MAX_THREADS)
        ok = []
        for k, i in enumerate(order):
            try:
                _raise_for(rcs[k], frames[k])
                ok.append(k)
            except Exception as exc:  # noqa: BLE001
                results[i] = exc
                plans.pop(i)
        order = [order[k] for k in ok]
        # the tables name member j's quantization tables 4 * j + c
        q16 = np.concatenate([q16[4 * k:4 * k + 4] for k in ok]) if ok else q16[:4]
        starts = [int(starts[k]) // 64 for k in ok]
    t = time.perf_counter()
    quant = q16.astype(np.int32)
    tables = build_tables([plans[i] for i in order], starts)
    packed, layout = pack_tables(quant, tables, pinned)
    if split is not None:
        split["tables"] = time.perf_counter() - t
    return Batch(results, order, plans, coefs, torch.from_numpy(quant).reshape(-1), tables,
                 packed, layout)


def upload(batch: Batch, dev: torch.device):
    """The kernels' inputs on ``dev`` -> (coefs, quant, K18's table,
    members, K19's tiles): on a card the coefficients and the packed
    buffer in a copy each (from pinned memory, no wait), the tables as
    views of it; on the CPU the host tensors, the segment table and no
    tiles (the plain versions')."""
    if dev.type != "cuda":
        return batch.coefs, batch.quant, batch.tables.segments, batch.tables.members, None
    coefs = batch.coefs.to(dev, non_blocking=True)
    quant, k18_tiles, k19_tiles, members = table_views(
        batch.packed.to(dev, non_blocking=True), batch.layout)
    return coefs, quant, k18_tiles, members, k19_tiles


def run_kernels(batch: Batch, dev: torch.device, split: Optional[Dict[str, float]] = None):
    """The device half: upload, K18, K19 on ``dev`` (their plain versions on
    the CPU) -> (planes, rgb) tensors on ``dev``. Nothing here waits for a
    card unless ``split`` is given: it receives each step's seconds,
    synchronized."""
    on_card = dev.type == "cuda"

    def mark(name, since):
        if split is None:
            return since
        if on_card:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        split[name] = now - since
        return now

    t = time.perf_counter()
    coefs, quant, k18_table, members, k19_tiles = upload(batch, dev)
    t = mark("upload", t)
    planes = idct_planes(coefs, quant, k18_table, batch.tables.plane_bytes)
    t = mark("k18", t)
    rgb = color_planes(planes, members, batch.tables.out_bytes, k19_tiles)
    mark("k19", t)
    return planes, rgb


def finish(batch: Batch, rgb: np.ndarray) -> List[object]:
    """Each member's ``Decoded`` from the batch's RGB bytes on the host."""
    results = list(batch.results)
    for i, (off, w, h) in zip(batch.order, batch.tables.outs):
        pl = batch.plans[i]
        img = rgb[off:off + w * h * 3].reshape(h, w, 3).copy()
        results[i] = Decoded(rgb=img, offset=(pl.x0, pl.y0), frame_size=(pl.full_w, pl.full_h))
    return results


def decode_batch(items: Sequence[Tuple[bytes, int, Optional[Tuple[int, int, int, int]]]],
                 device: _Device = "cuda", max_pixels: Optional[int] = None,
                 split: Optional[Dict[str, float]] = None) -> List[object]:
    """Decode ``items`` = [(JPEG bytes, scale_num, roi or None)], roi an
    (x, y, w, h) window of the scaled frame: the entropy decode of all on
    host threads, then one K18 and one K19 launch for the batch on
    ``device``. Returns, per item, a ``Decoded``, None (a window that is
    empty after clamping) or the exception that member raised (a member
    that fails fails alone). ``max_pixels`` bounds a source's declared
    size. ``split``, when given, receives the seconds of each step (host
    entropy decode, the kernels' tables, upload, K18, K19, readback;
    synchronized on a card)."""
    dev = _device(device)
    t0 = time.perf_counter()
    batch = entropy_decode(items, pinned=dev.type == "cuda", max_pixels=max_pixels, split=split)
    if split is not None:
        split["entropy"] = time.perf_counter() - t0 - split["tables"]
    if not batch.order:
        return batch.results
    _planes, rgb = run_kernels(batch, dev, split)
    t = time.perf_counter()
    host = rgb.cpu().numpy()
    if split is not None:
        split["readback"] = time.perf_counter() - t
    return finish(batch, host)


def decode(data: bytes, scale_num: int = 8, roi: Optional[Tuple[int, int, int, int]] = None,
           device: _Device = "cuda", max_pixels: Optional[int] = None) -> Optional[Decoded]:
    """One file through ``decode_batch``: a ``Decoded``, None for a window
    that is empty after clamping; raises the member's failure."""
    result = decode_batch([(data, scale_num, roi)], device, max_pixels)[0]
    if isinstance(result, BaseException):
        raise result
    return result
