"""Kernels K16 (``csrc/jpeg_trellis.cu``) and K17 (``csrc/jpeg_fdct.cu``) as
written for the card, compiled for the host (``tests/cuda_host_kernels.py``:
a CUDA thread a host thread, warps and CTAs meeting at real barriers),
against their plain versions on the CPU.

The CUDA sources themselves run nowhere else without a card. Here their
index arithmetic, shared-memory layout and synchronisation meet the edge
frames of ``flyimg_tpu_torch.testing.jpeg_frames`` (all but the large
ones, which the emulation would take minutes over) and ragged sizes at
every kind of sampling. On the card, ``chip_smoke.py`` phase 3 holds the
kernels on every frame, and the float intrinsics round there as the host
rounds each single operation here.

Bound: exact (int16 coefficients).
"""

import functools

import numpy as np
import pytest
import torch

from cuda_host_kernels import build, missing
from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables
from flyimg_tpu_torch.testing import jpeg_frames

torch.set_num_threads(1)

SMALL_CASES = [c for c in jpeg_frames.CASES if c[0] not in ("source", "photo1920x1080")]
RAGGED = [((17, 9), 90, (1, 1)), ((17, 9), 90, (2, 2)), ((17, 9), 50, (4, 2)),
          ((45, 37), 100, (2, 4)), ((45, 37), 75, (1, 3)), ((45, 37), 90, (3, 2))]


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    reason = missing()
    if reason:
        pytest.skip(f"the kernels cannot be built for the host here: {reason}")
    out = str(tmp_path_factory.mktemp("cuda_host"))
    return {"K16": build("jpeg_trellis", out), "K17": build("jpeg_fdct", out)}


def _aligned(arr: np.ndarray) -> np.ndarray:
    """A 16-byte-aligned copy (the kernels read aligned 16-byte words)."""
    buf = np.empty(arr.nbytes + 16, np.uint8)
    off = (-buf.ctypes.data) % 16
    out = buf[off:off + arr.nbytes].view(arr.dtype).reshape(arr.shape)
    out[...] = arr
    return out


@functools.lru_cache(maxsize=None)
def _ragged(w, h):
    rng = np.random.default_rng(w * 31 + h)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(yy / (3.0 + c) + xx / (5.0 - c)) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
    img.setflags(write=False)
    return img


def _k16(lib, rgb, quality, sampling):
    import ctypes

    h, w = rgb.shape[:2]
    dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(sampling))
    out = _aligned(np.full((sum(a * b for a, b in dims), 64), 12345, np.int16))
    img = _aligned(np.ascontiguousarray(rgb))
    params = _aligned(jpeg_tables.trellis_param_block(quality).copy())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flyimg_jpeg_trellis.argtypes = [p, p, i, i, i, i, p, p]
    assert lib.flyimg_jpeg_trellis(img.ctypes.data, out.ctypes.data, w, h, sampling[0],
                                   sampling[1], params.ctypes.data, None) == 0
    return out


def _k17(lib, planes, tables, which):
    import ctypes

    params = jpeg_enc._FdctParams()
    params.nplanes = len(planes)
    offset = blocks = 0
    for n, plane in enumerate(planes):
        params.bw[n] = plane.shape[1] // 8
        params.table[n] = which[n]
        params.block_off[n] = blocks
        params.plane_off[n] = offset
        offset += plane.size
        blocks += plane.size // 64
    params.block_off[len(planes)] = blocks
    packed = _aligned(np.concatenate([plane.reshape(-1) for plane in planes]))
    divisors = _aligned(jpeg_enc.divisor_words(tables))
    out = _aligned(np.full((blocks, 64), 12345, np.int16))
    p = ctypes.c_void_p
    lib.flyimg_jpeg_fdct.argtypes = [p, p, ctypes.POINTER(jpeg_enc._FdctParams), p,
                                     ctypes.c_int, p]
    assert lib.flyimg_jpeg_fdct(packed.ctypes.data, out.ctypes.data, ctypes.byref(params),
                                divisors.ctypes.data, len(tables), None) == 0
    return out


def _cases():
    for name, q, s in SMALL_CASES:
        yield pytest.param(name, q, s, id=f"{name}-q{q}-{s[0]}x{s[1]}")
    for (w, h), q, s in RAGGED:
        yield pytest.param(f"ragged{w}x{h}", q, s, id=f"ragged{w}x{h}-q{q}-{s[0]}x{s[1]}")


def _frame(name):
    if name.startswith("ragged"):
        return _ragged(*(int(v) for v in name[6:].split("x")))
    return jpeg_frames.frame(name)


@pytest.mark.parametrize("name,quality,sampling", list(_cases()))
def test_k16_source_equals_trellis_plain(kernels, name, quality, sampling):
    img = _frame(name)
    got = _k16(kernels["K16"], img, quality, sampling)
    want = jpeg_plain.trellis_plain(torch.from_numpy(img.copy()), quality, sampling).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,quality,sampling", list(_cases()))
def test_k17_source_equals_fdct_islow_plain(kernels, name, quality, sampling):
    rgb = torch.from_numpy(_frame(name).copy())
    planes = jpeg_plain.grid_planes(rgb, sampling)
    tables = jpeg_tables.qtables(quality)
    got = _k17(kernels["K17"], [p.numpy() for p in planes], tables, (0, 1, 1))
    want = torch.cat([jpeg_plain.fdct_islow_plain(p, tables[t])
                      for p, t in zip(planes, (0, 1, 1))]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["checker1", "checker8", "noise9x9", "source"])
def test_k17_source_equals_fdct_islow_plain_on_cmyk_planes(kernels, name):
    planes = jpeg_plain.cmyk_grid_planes(torch.from_numpy(_frame(name).copy()))
    table = [jpeg_tables.build_qtable(100, jpeg_tables.LUMA_Q)]
    got = _k17(kernels["K17"], [p.numpy() for p in planes], table, (0, 0, 0, 0))
    want = torch.cat([jpeg_plain.fdct_islow_plain(p, table[0]) for p in planes]).numpy()
    np.testing.assert_array_equal(got, want)
