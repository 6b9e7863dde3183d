"""The port's JPEG encoder: two CUDA kernels and a host entropy writer.

The JAX package encodes JPEG with its native library: ``moz_1`` with
``fc_jpeg_encode_trellis`` (its own float DCT and rate-distortion
trellis, then libjpeg's optimized Huffman tables and progressive scans),
``moz_0`` with ``fc_jpeg_encode`` (libjpeg's baseline at any luma
sampling factor) and ``clsp_CMYK`` with Pillow (``_encode_cmyk_jpeg``).
The card machine has no libjpeg, so the port splits the work:

- kernel K16 (``csrc/jpeg_trellis.cu``, ``trellis_coefficients_group``):
  colour conversion, chroma box mean, float DCT and the trellis, one launch
  for a group of encodes through a frame table (``trellis_coefficients``:
  a group of one);
- kernel K17 (``csrc/jpeg_fdct.cu``, ``fdct_coefficients``): libjpeg's
  islow FDCT and quantization over u8 planes laid out as libjpeg's
  preprocessing leaves them (``jpeg_plain.grid_planes``,
  ``cmyk_grid_planes``), one launch an encode or a group's planes;
- ``codecs/native/jpeg_writer.cpp`` (g++, no libjpeg): markers, Huffman
  tables and scans, byte for byte as libjpeg writes the same
  coefficients.

``encode_trellis``, ``encode_plain`` and ``encode_cmyk`` upload the frame,
launch the kernel, read the coefficients back and write the file;
``encode_trellis_group`` and ``encode_plain_group`` do it for the codec
batcher's encode group in one launch, the writer a member on threads. On a
CUDA device a kernel launches or raises; only ``device="cpu"`` runs the
kernels' plain versions (``codecs/jpeg_plain.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.codecs import jpeg_plain, jpeg_tables
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import ExecFailedException

_Device = Union[str, torch.device]


def valid_sampling(sampling: Tuple[int, int]) -> bool:
    """The JAX package's ``fc_samp_valid``: h and v in 1..4, h * v <= 8."""
    h, v = (int(f) for f in sampling)
    return 1 <= h <= 4 and 1 <= v <= 4 and h * v <= 8


def _check_sampling(sampling) -> Tuple[int, int]:
    sampling = (int(sampling[0]), int(sampling[1]))
    if not valid_sampling(sampling):
        raise ExecFailedException(f"JPEG encode failed: sampling factors {sampling}")
    return sampling


def _device(device: _Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _upload(rgb: np.ndarray, dev: torch.device) -> torch.Tensor:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if not rgb.flags.writeable:  # torch.from_numpy wants a writable array
        rgb = rgb.copy()
    if rgb.ndim != 3 or rgb.shape[2] != 3 or min(rgb.shape[:2]) < 1 \
            or max(rgb.shape[:2]) > 65535:
        raise ExecFailedException(f"JPEG encode takes [h, w, 3] u8, got {rgb.shape}")
    return torch.from_numpy(rgb).to(dev)


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------


def bind_trellis(lib):
    """``lib`` (a build of ``csrc/jpeg_trellis.cu``) with its entries'
    argument types set."""
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flyimg_jpeg_trellis_frame.argtypes = [p, p, i, i, i, i, i, p, ctypes.POINTER(i)]
        lib.flyimg_jpeg_trellis_frame.restype = i
        lib.flyimg_jpeg_trellis_frame_bytes.argtypes = []
        lib.flyimg_jpeg_trellis_frame_bytes.restype = i
        lib.flyimg_jpeg_trellis_frames.argtypes = [p, i, i, i, p, p]
        lib.flyimg_jpeg_trellis_frames.restype = i
        lib._flyimg_bound = True
    return lib


def _trellis_lib():
    return bind_trellis(cuda_build.load("jpeg_trellis"))


#: K16's constants on each card, a quality (the launch reads them from there)
_TRELLIS_PARAMS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _trellis_params(quality: int, device: torch.device) -> torch.Tensor:
    key = (int(quality), device)
    params = _TRELLIS_PARAMS.get(key)
    if params is None:
        params = torch.from_numpy(jpeg_tables.trellis_param_block(quality).copy()).to(device)
        _TRELLIS_PARAMS[key] = params
    return params


def trellis_coefficients(rgb: torch.Tensor, quality: int,
                         sampling: Tuple[int, int]) -> torch.Tensor:
    """Trellis-quantized coefficients of a [H, W, 3] u8 image: kernel K16
    (a frame table of one row) on a CUDA tensor,
    ``jpeg_plain.trellis_plain`` on a CPU tensor. int16 [blocks, 64] in
    zigzag order (Y's blocks, then Cb's, then Cr's)."""
    return trellis_coefficients_group([rgb], quality, sampling)[0]


#: K16 launches since the last reset (a plain integer)
trellis_coefficients.launches = 0


def trellis_coefficients_group(frames: Sequence[torch.Tensor], quality: int,
                               sampling: Tuple[int, int]) -> List[torch.Tensor]:
    """``trellis_coefficients`` of several [H, W, 3] u8 frames at one
    quality and sampling: on CUDA tensors kernel K16 in ONE launch, its
    CTAs mapped to (frame, strip) through a frame table; on CPU tensors
    the plain version a frame. Each frame's coefficients equal its single
    call's."""
    sampling = _check_sampling(sampling)
    if not frames:
        return []
    for rgb in frames:
        if rgb.dtype != torch.uint8 or rgb.dim() != 3 or rgb.shape[2] != 3:
            raise ValueError(f"K16 takes u8 [H, W, 3], got {rgb.dtype} {tuple(rgb.shape)}")
    dev = frames[0].device
    if dev.type == "cpu":
        return [jpeg_plain.trellis_plain(f, quality, sampling) for f in frames]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _trellis_lib()
    stride = lib.flyimg_jpeg_trellis_frame_bytes()
    table = np.zeros(len(frames) * stride, np.uint8)
    outs, keep = [], []
    ctas = 0
    smem = ctypes.c_int()
    for k, rgb in enumerate(frames):
        rgb = rgb.contiguous()
        if rgb.data_ptr() % 16:  # K16 reads whole aligned 16-byte words
            rgb = rgb.clone()
        keep.append(rgb)
        h, w = rgb.shape[:2]
        dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(sampling))
        out = torch.empty((sum(bw * bh for bw, bh in dims), 64), dtype=torch.int16, device=dev)
        outs.append(out)
        n = lib.flyimg_jpeg_trellis_frame(rgb.data_ptr(), out.data_ptr(), w, h, sampling[0],
                                          sampling[1], ctas, table.ctypes.data + k * stride,
                                          ctypes.byref(smem))
        if n < 0:
            raise ValueError(f"K16 does not take a {w}x{h} frame at {sampling}")
        ctas += n
    params = _trellis_params(quality, dev)
    rows = torch.from_numpy(table).to(dev)
    rc = lib.flyimg_jpeg_trellis_frames(rows.data_ptr(), len(frames), ctas, smem.value,
                                        params.data_ptr(),
                                        cuda_build.current_stream(dev.index))
    cuda_build.check(rc, "jpeg_trellis")
    trellis_coefficients.launches += 1
    del keep, rows
    return outs


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------

#: K17's plane limit (csrc/jpeg_fdct.cu kMaxPlanes): a group of 32
#: three-component encodes
MAX_PLANES = 96


class _FdctParams(ctypes.Structure):
    # mirrors K17Params in csrc/jpeg_fdct.cu
    _fields_ = [
        ("nplanes", ctypes.c_int),
        ("bw", ctypes.c_int * MAX_PLANES),
        ("table", ctypes.c_int * MAX_PLANES),
        ("block_off", ctypes.c_int * (MAX_PLANES + 1)),
        ("plane_off", ctypes.c_longlong * MAX_PLANES),
    ]


def divisor_words(tables: Sequence[Sequence[int]]) -> np.ndarray:
    """K17's divisors of natural-order ``tables``: libjpeg-turbo's
    reciprocal, correction and shift (``jpeg_plain.divisor_rows``) of each
    natural index n = v * 8 + c, u32 [table][kind][c][v] (a column's 8
    words side by side)."""
    rows = np.array([jpeg_plain.divisor_rows(tuple(int(q) for q in t)) for t in tables],
                    dtype=np.uint32)
    return np.ascontiguousarray(rows.reshape(len(tables), 3, 8, 8).transpose(0, 1, 3, 2))


#: K17's divisors on each card, a table set
_DIVISORS: Dict[Tuple[tuple, torch.device], torch.Tensor] = {}


def _divisors(tables: Sequence[Sequence[int]], device: torch.device) -> torch.Tensor:
    key = (tuple(tuple(int(q) for q in t) for t in tables), device)
    words = _DIVISORS.get(key)
    if words is None:
        words = torch.from_numpy(divisor_words(key[0]).view(np.int32)).to(device)
        _DIVISORS[key] = words
    return words


def _fdct_lib():
    lib = cuda_build.load("jpeg_fdct")
    if not getattr(lib, "_flyimg_bound", False):
        p = ctypes.c_void_p
        lib.flyimg_jpeg_fdct.argtypes = [p, p, ctypes.POINTER(_FdctParams), p, ctypes.c_int, p]
        lib.flyimg_jpeg_fdct.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


def fdct_coefficients(planes: Sequence[torch.Tensor], tables: Sequence[Sequence[int]],
                      which: Sequence[int]) -> torch.Tensor:
    """Quantized islow-FDCT coefficients of u8 planes, each on its block
    grid [bh * 8, bw * 8], plane i quantized by ``tables[which[i]]``
    (natural order; at most two tables): kernel K17 over all planes in one
    launch on CUDA tensors, ``jpeg_plain.fdct_islow_plain`` on CPU
    tensors. int16 [blocks, 64] zigzag, the planes' blocks one after
    another."""
    if not 1 <= len(planes) <= MAX_PLANES or len(which) != len(planes) \
            or not 1 <= len(tables) <= 2:
        raise ValueError(f"fdct_coefficients takes 1-{MAX_PLANES} planes and 1-2 tables")
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[0] % 8 or p.shape[1] % 8 \
                or p.numel() == 0:
            raise ValueError(f"a K17 plane is u8 [bh * 8, bw * 8], got {p.dtype} "
                             f"{tuple(p.shape)}")
    dev = planes[0].device
    if dev.type == "cpu":
        return torch.cat([jpeg_plain.fdct_islow_plain(p, tables[t])
                          for p, t in zip(planes, which)])
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    params = _FdctParams()
    params.nplanes = len(planes)
    offset, blocks = 0, 0
    for i, p in enumerate(planes):
        params.bw[i] = p.shape[1] // 8
        params.table[i] = int(which[i])
        params.block_off[i] = blocks
        params.plane_off[i] = offset
        offset += p.numel()
        blocks += p.numel() // 64
    params.block_off[len(planes)] = blocks
    divisors = _divisors(tables, dev)
    packed = torch.cat([p.reshape(-1) for p in planes]) if len(planes) > 1 \
        else planes[0].reshape(-1).contiguous()
    if packed.data_ptr() % 8:  # K17 reads a block row as one 8-byte word
        packed = packed.clone()
    out = torch.empty((blocks, 64), dtype=torch.int16, device=dev)
    rc = _fdct_lib().flyimg_jpeg_fdct(packed.data_ptr(), out.data_ptr(),
                                      ctypes.byref(params), divisors.data_ptr(), len(tables),
                                      cuda_build.current_stream(dev.index))
    cuda_build.check(rc, "jpeg_fdct")
    fdct_coefficients.launches += 1
    return out


#: K17 launches since the last reset (a plain integer)
fdct_coefficients.launches = 0


# ---------------------------------------------------------------------------
# the host writer
# ---------------------------------------------------------------------------


def _writer():
    lib = cuda_build.load_host("jpeg")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fl_jpeg_write.restype = p
        lib.fl_jpeg_write.argtypes = [p, i, i, i, p, p, i, i, p,
                                      ctypes.POINTER(ctypes.c_size_t)]
        lib.fl_jpeg_free.restype = None
        lib.fl_jpeg_free.argtypes = [p]
        lib._flyimg_bound = True
    return lib


def write(coef: np.ndarray, width: int, height: int, factors: Sequence[Tuple[int, int]],
          tables: Sequence[Sequence[int]], *, cmyk: bool = False,
          progressive: bool = False, optimize: bool = True) -> bytes:
    """A JPEG file from int16 [blocks, 64] zigzag coefficients
    (``codecs/native/jpeg_writer.cpp``): YCbCr under JFIF (table 0 for Y,
    1 for chroma) or, with ``cmyk``, four components on table 0 under an
    Adobe marker; a baseline scan with the standard Huffman tables
    (``optimize`` off) or optimized ones, or, with ``progressive``,
    libjpeg's simple progression with tables optimized a scan."""
    lib = _writer()
    coef = np.ascontiguousarray(coef, dtype=np.int16)
    fac = np.ascontiguousarray(np.array(factors, dtype=np.int32).reshape(-1))
    q = np.ascontiguousarray(np.array(tables, dtype=np.uint16).reshape(-1))
    std = None if (optimize or progressive) else jpeg_tables.STD_HUFFMAN
    out_len = ctypes.c_size_t()
    ptr = lib.fl_jpeg_write(coef.ctypes.data, int(width), int(height), len(factors),
                            fac.ctypes.data, q.ctypes.data, int(bool(cmyk)),
                            int(bool(progressive)), std, ctypes.byref(out_len))
    if not ptr:
        raise ExecFailedException("JPEG write failed")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.fl_jpeg_free(ptr)


# ---------------------------------------------------------------------------
# entry functions
# ---------------------------------------------------------------------------


def encode_trellis(rgb: np.ndarray, quality: int = 90, sampling: Tuple[int, int] = (1, 1),
                   progressive: bool = True, *, device: _Device = "cuda") -> bytes:
    """[h, w, 3] u8 -> JPEG as the JAX package's ``fc_jpeg_encode_trellis``
    writes it: trellis-quantized coefficients (K16 on ``device``),
    optimized Huffman tables, progressive scans (or one baseline scan)."""
    sampling = _check_sampling(sampling)
    dev = _device(device)
    frame = _upload(rgb, dev)
    coef = trellis_coefficients(frame, quality, sampling).cpu().numpy()
    h, w = frame.shape[:2]
    return write(coef, w, h, jpeg_plain.ycc_factors(sampling), jpeg_tables.qtables(quality),
                 progressive=progressive, optimize=True)


def encode_plain(rgb: np.ndarray, quality: int = 90, optimize: bool = False,
                 progressive: bool = False, sampling: Tuple[int, int] = (1, 1), *,
                 device: _Device = "cuda") -> bytes:
    """[h, w, 3] u8 -> JPEG as the JAX package's ``fc_jpeg_encode`` writes
    it: libjpeg's colour conversion and downsampling, its islow FDCT (K17
    on ``device``), standard or optimized Huffman tables, baseline or
    progressive scans (progressive scans always optimize, as libjpeg's)."""
    sampling = _check_sampling(sampling)
    dev = _device(device)
    frame = _upload(rgb, dev)
    tables = jpeg_tables.qtables(quality)
    coef = fdct_coefficients(jpeg_plain.grid_planes(frame, sampling), tables,
                             (0, 1, 1)).cpu().numpy()
    h, w = frame.shape[:2]
    return write(coef, w, h, jpeg_plain.ycc_factors(sampling), tables,
                 progressive=progressive, optimize=optimize)


def _write_all(jobs) -> List[bytes]:
    """The host writer over a group's members on threads (each ctypes call
    releases the GIL)."""
    if len(jobs) == 1:
        return [write(*jobs[0][0], **jobs[0][1])]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as pool:
        return list(pool.map(lambda job: write(*job[0], **job[1]), jobs))


def encode_trellis_group(images: Sequence[np.ndarray], quality: int = 90,
                         sampling: Tuple[int, int] = (1, 1), *,
                         device: _Device = "cuda") -> List[bytes]:
    """``encode_trellis`` (progressive) of a group of frames at one quality
    and sampling: K16 in one launch for the group
    (``trellis_coefficients_group``), the writer a member on threads.
    Every member's bytes equal its single encode's."""
    sampling = _check_sampling(sampling)
    dev = _device(device)
    frames = [_upload(img, dev) for img in images]
    coefs = [c.cpu().numpy() for c in trellis_coefficients_group(frames, quality, sampling)]
    factors, tables = jpeg_plain.ycc_factors(sampling), jpeg_tables.qtables(quality)
    return _write_all([((c, f.shape[1], f.shape[0], factors, tables),
                        {"progressive": True, "optimize": True})
                       for c, f in zip(coefs, frames)])


def encode_plain_group(images: Sequence[np.ndarray], quality: int = 90,
                       sampling: Tuple[int, int] = (1, 1), *,
                       device: _Device = "cuda") -> List[bytes]:
    """``encode_plain`` (baseline, standard tables) of a group of frames at
    one quality and sampling: every member's planes through K17 in one
    launch (up to ``MAX_PLANES`` planes, so 32 members a launch), the
    writer a member on threads. Every member's bytes equal its single
    encode's."""
    sampling = _check_sampling(sampling)
    dev = _device(device)
    tables = jpeg_tables.qtables(quality)
    frames = [_upload(img, dev) for img in images]
    coefs: List[np.ndarray] = []
    per = MAX_PLANES // 3
    for lo in range(0, len(frames), per):
        chunk = frames[lo:lo + per]
        planes, counts = [], []
        for f in chunk:
            ps = jpeg_plain.grid_planes(f, sampling)
            planes.extend(ps)
            counts.append(sum(p.numel() // 64 for p in ps))
        out = fdct_coefficients(planes, tables, (0, 1, 1) * len(chunk)).cpu().numpy()
        start = 0
        for n in counts:
            coefs.append(out[start:start + n])
            start += n
    factors = jpeg_plain.ycc_factors(sampling)
    return _write_all([((c, f.shape[1], f.shape[0], factors, tables),
                        {"progressive": False, "optimize": False})
                       for c, f in zip(coefs, frames)])


def encode_cmyk(frame: np.ndarray, quality: int = 90, optimize: bool = False, *,
                device: _Device = "cuda") -> bytes:
    """[h, w, 3] u8 -> a CMYK JPEG as the JAX handler's
    ``_encode_cmyk_jpeg`` writes it through Pillow: the black extraction
    in f32, Pillow's inverted samples, libjpeg's islow FDCT (K17 on
    ``device``) at the luma table, one baseline scan under an Adobe
    marker, standard or optimized Huffman tables."""
    dev = _device(device)
    rgb = _upload(frame, dev)
    table = jpeg_tables.build_qtable(quality, jpeg_tables.LUMA_Q)
    coef = fdct_coefficients(jpeg_plain.cmyk_grid_planes(rgb), [table],
                             (0, 0, 0, 0)).cpu().numpy()
    h, w = rgb.shape[:2]
    return write(coef, w, h, [(1, 1)] * 4, [table], cmyk=True, optimize=optimize)
