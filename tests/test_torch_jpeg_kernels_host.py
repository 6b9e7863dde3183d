"""Kernels K16 (``csrc/jpeg_trellis.cu``) and K17 (``csrc/jpeg_fdct.cu``) of
the JPEG encoder, and K18 (``csrc/jpeg_idct.cu``) and K19
(``csrc/jpeg_color.cu``) of its decoder, as written for the card, compiled
for the host (``tests/cuda_host_kernels.py``:
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
    return {"K16": build("jpeg_trellis", out), "K17": build("jpeg_fdct", out),
            "K18": build("jpeg_idct", out), "K19": build("jpeg_color", out)}


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
    """K16 on one frame: a frame table of one row."""
    return _k16_frames(lib, [rgb], quality, sampling)[0]


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


def _k16_frames(lib, frames, quality, sampling):
    """K16 through its frame table: one launch for all ``frames``."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flyimg_jpeg_trellis_frame.argtypes = [p, p, i, i, i, i, i, p, ctypes.POINTER(i)]
    lib.flyimg_jpeg_trellis_frame.restype = i
    lib.flyimg_jpeg_trellis_frames.argtypes = [p, i, i, i, p, p]
    stride = lib.flyimg_jpeg_trellis_frame_bytes()
    table = _aligned(np.zeros(len(frames) * stride, np.uint8))
    imgs, outs, ctas, smem = [], [], 0, ctypes.c_int()
    for k, rgb in enumerate(frames):
        h, w = rgb.shape[:2]
        dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(sampling))
        outs.append(_aligned(np.full((sum(a * b for a, b in dims), 64), 12345, np.int16)))
        imgs.append(_aligned(np.ascontiguousarray(rgb)))
        ctas += lib.flyimg_jpeg_trellis_frame(imgs[-1].ctypes.data, outs[-1].ctypes.data, w, h,
                                              sampling[0], sampling[1], ctas,
                                              table.ctypes.data + k * stride, ctypes.byref(smem))
    params = _aligned(jpeg_tables.trellis_param_block(quality).copy())
    assert lib.flyimg_jpeg_trellis_frames(table.ctypes.data, len(frames), ctas, smem.value,
                                          params.ctypes.data, None) == 0
    return outs


@pytest.mark.parametrize("sampling", [(1, 1), (2, 2), (4, 1)])
def test_k16_frame_table_equals_each_frame_alone(kernels, sampling):
    """A group's frames in one K16 launch (the encode group's frame table)
    give each frame's own coefficients."""
    frames = [_ragged(17, 9), _ragged(45, 37), jpeg_frames.frame("noise9x9")]
    got = _k16_frames(kernels["K16"], frames, 75, sampling)
    for img, out in zip(frames, got):
        want = jpeg_plain.trellis_plain(torch.from_numpy(img.copy()), 75, sampling).numpy()
        np.testing.assert_array_equal(out, want)


def test_k17_takes_a_group_of_planes_in_one_launch(kernels):
    """Twelve frames' 36 planes (the encode group's moz_0 launch) in one
    K17 launch give each plane's own coefficients."""
    tables = jpeg_tables.qtables(90)
    planes = []
    for k in range(12):
        rgb = torch.from_numpy(_ragged(17 + k, 9 + 2 * k).copy())
        planes.extend(jpeg_plain.grid_planes(rgb, (2, 1)))
    which = (0, 1, 1) * 12
    got = _k17(kernels["K17"], [p.numpy() for p in planes], tables, which)
    want = torch.cat([jpeg_plain.fdct_islow_plain(p, tables[t])
                      for p, t in zip(planes, which)]).numpy()
    np.testing.assert_array_equal(got, want)


def _host_decode(kernels, monkeypatch, items, **options):
    """``jpeg_dec.decode_batch`` of ``items`` with K18 and K19 compiled for
    the host in place of the plain versions, each launch over the tile
    tables of the batch's segment and member tables (``idct_tiles``,
    ``color_tiles``, as ``build_tables`` makes them for a card) also held
    to its plain version's bytes (max difference 0)."""
    import ctypes

    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    p, i = ctypes.c_void_p, ctypes.c_int
    k18, k19 = kernels["K18"], kernels["K19"]
    k18.flyimg_jpeg_idct.argtypes = [p, p, p, i, p, p]
    k19.flyimg_jpeg_color.argtypes = [p, p, p, i, p, p]

    def idct(coefs, quant, segs, nbytes):
        c = _aligned(coefs.numpy())
        q = _aligned(quant.numpy())
        t = _aligned(jpeg_dec.idct_tiles(segs.numpy()))
        # rounded up to 16 bytes, as on the card: K19 stages whole chunks
        out = _aligned(np.full(-(-nbytes // 16) * 16, 77, np.uint8))
        assert k18.flyimg_jpeg_idct(c.ctypes.data, q.ctypes.data, t.ctypes.data, len(t),
                                    out.ctypes.data, None) == 0
        np.testing.assert_array_equal(out[:nbytes], plain.k18(coefs, quant, segs, nbytes).numpy())
        return torch.from_numpy(out)

    def color(planes, mems, nbytes, tiles=None):
        assert tiles is None
        m = _aligned(mems.numpy())
        t = _aligned(jpeg_dec.color_tiles(mems.numpy()))
        out = np.full(nbytes, 77, np.uint8)
        assert k19.flyimg_jpeg_color(planes.numpy().ctypes.data, m.ctypes.data,
                                     t.ctypes.data, len(t), out.ctypes.data, None) == 0
        np.testing.assert_array_equal(out, plain.k19(planes, mems, nbytes).numpy())
        return torch.from_numpy(out)

    monkeypatch.setattr(jpeg_dec, "idct_planes", idct)
    monkeypatch.setattr(jpeg_dec, "color_planes", color)
    return jpeg_dec.decode_batch(items, device="cpu", **options)


def _fixture_bytes():
    import glob
    import os

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
    return [open(f, "rb").read() for f in sorted(glob.glob(os.path.join(root, "*.jpg")))]


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
def test_k18_k19_sources_equal_their_plain_versions_on_every_fixture(kernels, monkeypatch,
                                                                     scale):
    """Every tests/data/jpeg file at one DCT scale, as one batch: one K18
    and one K19 launch, each equal to its plain version."""
    items = [(data, scale, None) for data in _fixture_bytes()]
    for got in _host_decode(kernels, monkeypatch, items):
        assert got.rgb.ndim == 3


def test_k18_k19_sources_on_edge_sizes_samplings_windows_and_damage(kernels, monkeypatch,
                                                                    tmp_path):
    """Sizes 1x1, 7x9 and 17x33 at the six luma samplings, windows at the
    edges of a frame at each scale, and a damaged file's extreme
    coefficients, in one batch."""
    import jpeg_test_files as jt

    enc = jt.encoder(str(tmp_path))
    items = []
    for sampling in [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (2, 4)]:
        for w, h in [(1, 1), (7, 9), (17, 33)]:
            items.append((enc(jt.photo(w, h, w + h), 90, sampling, bool(w % 2)), 8, None))
    data = enc(jt.photo(61, 45, 7), 85, (2, 2), True)
    for scale in (1, 2, 4, 8):
        fw, fh = -(-61 * scale // 8), -(-45 * scale // 8)
        items += [(data, scale, (fw // 3, fh // 4, fw // 2, fh // 2)),
                  (data, scale, (fw - 3, fh - 2, 3, 2)), (data, scale, (0, 0, 2, fh))]
    items += [(jt.corrupt(enc(jt.photo(120, 90, 5), 90, (2, 2), False, 4), 0), s, None)
              for s in (2, 4, 8)]
    for got in _host_decode(kernels, monkeypatch, items):
        assert got.rgb.ndim == 3


def test_k18_k19_sources_on_extreme_coefficients_of_cut_arithmetic_files(kernels, monkeypatch,
                                                                         tmp_path):
    """Cut arithmetic-coded files, whose coder runs on zero data to the end
    of the scan and whose smoothed blocks then reach past 16 bits: K18 at
    2x2 keeps pass 1's column 0 in 32 bits (it wraps in pass 2) and
    saturates the odd columns, as the SIMD IDCT does, at every scale."""
    import jpeg_test_files as jt

    enc = jt.encoder(str(tmp_path))
    items = []
    for k, sampling in enumerate([(1, 1), (2, 2)]):
        data = jt.truncate(enc(jt.photo(203, 157, 11 + k), 85, sampling, True, 0, arith=True),
                           0.03)
        items += [(data, s, None) for s in (1, 2, 4, 8)]
    for got in _host_decode(kernels, monkeypatch, items):
        assert got.rgb.ndim == 3


def test_k19_source_decodes_a_fourth_component_as_gray(kernels, monkeypatch):
    """A four-component member's fourth component as its own gray K19
    member in the same launch (``decode_batch(fourth=True)``, the RGBA and
    CMYK TIFF JPEG route), beside three-component and gray members, with
    the colour space set from outside (``color=``, RGB: the three first
    components as they are): K19's source equals its plain version, and
    the fourth plane is the member's own K sample."""
    import os

    import numpy as np

    from flyimg_tpu_torch.codecs import jpeg_dec

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
    files = [open(os.path.join(root, f"q90_cmyk{s}.jpg"), "rb").read()
             for s in ("", "_h2v1", "_h2v2")]
    cmyk = files[0]
    items = [(cmyk, 8, None), (files[1], 8, None), (files[2], 2, None),
             (cmyk, 4, (3, 2, 17, 11))]
    got = _host_decode(kernels, monkeypatch, items, color=2, fourth=True)
    assert all(out.fourth is not None for out in got)
    alone = jpeg_dec.decode(cmyk, 8, None, device="cpu")
    assert got[0].rgb.shape == alone.rgb.shape and got[0].fourth.shape == alone.rgb.shape[:2]
    assert not np.array_equal(got[0].fourth, got[0].rgb[..., 0])


# ---------------------------------------------------------------------------
# K18's and K19's tile tables (no compiler needed)


def _frame_header(w, h, sampling, ncomp=3):
    """A YCbCr (or gray) frame's header as the reader reports it (no file):
    luma at ``sampling``, chroma 1x1."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    frame = jpeg_dec.FlJpegFrame()
    frame.width, frame.height, frame.ncomp = w, h, ncomp
    frame.color = 1 if ncomp == 3 else 0
    mh, mv = sampling if ncomp == 3 else (1, 1)
    frame.max_h, frame.max_v = mh, mv
    frame.mcus_x, frame.mcus_y = -(-w // (8 * mh)), -(-h // (8 * mv))
    frame.single_scan = 1
    for c in range(ncomp):
        fh, fv = (mh, mv) if c == 0 else (1, 1)
        frame.comp_h[c], frame.comp_v[c] = fh, fv
        frame.blocks_w[c], frame.blocks_h[c] = -(-w * fh // (8 * mh)), -(-h * fv // (8 * mv))
        frame.alloc_w[c], frame.alloc_h[c] = frame.mcus_x * fh, frame.mcus_y * fv
    return frame


def _tile_batches():
    """name -> [(frame, scale, roi)]: mixed scales and samplings, ragged
    sizes, gray, and windows (odd first rows and columns, edges)."""
    sizes = [(1, 1), (7, 9), (17, 33), (203, 157), (1000, 37), (4032, 24)]
    samplings = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (2, 4)]
    mixed = [(_frame_header(w, h, s), 1 << (k % 4), None)
             for k, ((w, h), s) in enumerate((size, s) for size in sizes for s in samplings)]
    gray = [(_frame_header(w, h, (1, 1), ncomp=1), scale, None)
            for (w, h) in sizes for scale in (1, 2, 4, 8)]
    windows = []
    for s in samplings:
        frame = _frame_header(611, 453, s)
        for scale in (1, 2, 4, 8):
            fw, fh = -(-611 * scale // 8), -(-453 * scale // 8)
            windows += [(frame, scale, (fw // 3, fh // 4 + 1, fw // 2, fh // 2)),
                        (frame, scale, (fw - 3, fh - 2, 3, 2)),
                        (frame, scale, (1, 1, fw - 2, 1)), (frame, scale, (0, 0, 2, fh))]
    return {"mixed": mixed, "gray": gray, "windows": windows,
            "all": mixed + gray + windows}


def _tables(items):
    from flyimg_tpu_torch.codecs import jpeg_dec

    plans = [p for p in (jpeg_dec.plan_member(f, s, roi) for f, s, roi in items) if p]
    starts, block = [], 0
    for pl in plans:
        starts.append(block)
        block += jpeg_dec.coef_count(pl.frame) // 64
    return plans, jpeg_dec.build_tables(plans, starts)


@pytest.mark.parametrize("batch", ["mixed", "gray", "windows", "all"])
def test_idct_tiles_cover_every_block_once_within_one_segment_row(batch):
    """Every block of every segment is in exactly one K18 tile, at its own
    coefficient block and output byte, with its segment's scale, table and
    pitch; a tile is one run of one block row of one segment (so one
    member and one scale) of at most IDCT_TILE_BLOCKS blocks, starting 16
    samples or a multiple of that into the row; and the tiles' samples
    cover the planes exactly once."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    _plans, tables = _tables(_tile_batches()[batch])
    _check_idct_tiles(tables, tables.idct_tiles, jpeg_dec.idct_tile_blocks(tables.blocks))


@pytest.mark.parametrize("most", [16, 32, 64])
def test_idct_tiles_of_each_length_cover_every_block_once(most):
    """The tile table at each length K18 takes (``idct_tiles``' ``most``,
    as ``idct_tile_blocks`` picks by batch size and ``jpeg_breakdown``
    times) holds the same as at the batch's own length."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    _plans, tables = _tables(_tile_batches()["all"])
    _check_idct_tiles(tables, jpeg_dec.idct_tiles(tables.segments.numpy(), most), most)


def test_idct_tile_blocks_tiers():
    """16 blocks a tile below 2^13 blocks, 32 below 2^15, 64 from there."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    assert [jpeg_dec.idct_tile_blocks(n) for n in (1, 8191, 8192, 32767, 32768, 10 ** 7)] \
        == [16, 16, 32, 32, 64, 64]


def _check_idct_tiles(tables, tiles, most):
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    segs = tables.segments.numpy()
    home = {}   # coefficient block -> (segment, block row, output byte)
    for k, seg in enumerate(segs):
        for by in range(seg[plain.SEG_NBY]):
            for bx in range(seg[plain.SEG_NBX]):
                coef = (seg[plain.SEG_COEF] + (seg[plain.SEG_BY0] + by) * seg[plain.SEG_GRID_W]
                        + seg[plain.SEG_BX0] + bx)
                out = seg[plain.SEG_OUT] + (by * seg[plain.SEG_PITCH] + bx) * seg[plain.SEG_SCALE]
                assert coef not in home
                home[int(coef)] = (k, by, int(out))
    assert tiles.dtype == jpeg_dec.IDCT_TILE and tiles.dtype.itemsize == 32
    assert tables.blocks == len(home) == int(tiles["n"].sum())
    seen = set()
    covered = np.zeros(tables.plane_bytes, np.int32)
    for t in tiles:
        n, scale, pitch = int(t["n"]), int(t["scale"]), int(t["pitch"])
        assert 1 <= n <= most <= jpeg_dec.IDCT_TILE_BLOCKS
        rows = {home[int(t["coef"]) + b][:2] for b in range(n)}
        assert len(rows) == 1, "a tile crosses a block row or a segment"
        k = rows.pop()[0]
        seg = segs[k]
        assert (scale, int(t["qt"]), pitch) == (seg[plain.SEG_SCALE], seg[plain.SEG_QT],
                                              seg[plain.SEG_PITCH])
        bx = (int(t["coef"]) - seg[plain.SEG_COEF]) % seg[plain.SEG_GRID_W] - seg[plain.SEG_BX0]
        assert bx * scale % 16 == 0, "a tile starts off a 16-sample step of its row"
        for b in range(n):
            assert int(t["out"]) + b * scale == home[int(t["coef"]) + b][2]
            seen.add(int(t["coef"]) + b)
            first = int(t["out"]) + b * scale
            for r in range(scale):
                covered[first + r * pitch:first + r * pitch + scale] += 1
    assert seen == set(home)
    assert (covered == 1).all()


@pytest.mark.parametrize("batch", ["mixed", "gray", "windows", "all"])
def test_color_tiles_cover_every_pixel_once_within_one_member_row_pair(batch):
    """Every output pixel of every member is in exactly one K19 strip; a
    strip lies in one member's window, its rows in one chroma row pair
    (two rows from an even frame row, or one), its columns a run of at most
    COLOR_STRIP_COLS starting at a multiple of 16."""
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    plans, tables = _tables(_tile_batches()[batch])
    mems = tables.members.numpy()
    tiles = tables.color_tiles
    assert tiles.dtype == jpeg_dec.COLOR_TILE and tiles.dtype.itemsize == 16
    covered = np.zeros(tables.out_bytes // 3, np.int32)
    assert tables.pixels == covered.size == sum(pl.w * pl.h for pl in plans)
    cols = jpeg_dec.COLOR_STRIP_COLS
    for t in tiles:
        mem = mems[int(t["member"])]
        w, h, y0 = int(mem[plain.MEM_W]), int(mem[plain.MEM_H]), int(mem[plain.MEM_Y0])
        y, x0, nw = int(t["y"]), int(t["x0"]), int(t["nw"])
        assert x0 % 16 == 0 and 1 <= nw <= cols and x0 + nw <= w
        assert y0 <= y < y0 + h and (y % 2 == 0 or y == y0)
        nr = min(2 - (y & 1), y0 + h - y)
        first = int(mem[plain.MEM_OUT]) // 3 + (y - y0) * w + x0
        for r in range(nr):
            covered[first + r * w:first + r * w + nw] += 1
    assert (covered == 1).all()


def test_tile_tables_hold_offsets_past_2_31():
    """Sixteen whole 12000x9000 4:2:0 decodes in one group: K18's tiles
    reach plane bytes and K19's members output bytes past 2^31, each tile's
    64-bit offsets the exact sums of its segment's."""
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    _plans, tables = _tables([(_frame_header(12000, 9000, (2, 2)), 8, None)] * 16)
    segs, tiles = tables.segments.numpy(), tables.idct_tiles
    assert tables.plane_bytes > 2 ** 31 and tables.out_bytes > 2 ** 31
    start = 0
    for seg in segs:
        nbx, nby = int(seg[plain.SEG_NBX]), int(seg[plain.SEG_NBY])
        count = -(-nbx // jpeg_dec.IDCT_TILE_BLOCKS) * nby
        last = tiles[start + count - 1]
        by, bx = nby - 1, nbx - int(last["n"])
        assert int(last["coef"]) == (int(seg[plain.SEG_COEF]) + (int(seg[plain.SEG_BY0]) + by)
                                     * int(seg[plain.SEG_GRID_W]) + int(seg[plain.SEG_BX0]) + bx)
        assert int(last["out"]) == int(seg[plain.SEG_OUT]) + (by * int(seg[plain.SEG_PITCH])
                                                              + bx) * int(seg[plain.SEG_SCALE])
        start += count
    assert start == len(tiles) and int(tiles["out"][-1]) > 2 ** 31
    assert int(tables.color_tiles["member"][-1]) == 15


def test_k18_k19_sources_on_windows_of_every_layout(kernels, monkeypatch, tmp_path):
    """Windows with odd origins (a strip of one row first) at the six luma
    samplings and on the CMYK, YCCK, gray and Adobe RGB fixtures (the
    generic body), at every scale, in one batch."""
    import os

    import jpeg_test_files as jt

    from flyimg_tpu_torch.codecs import jpeg_dec

    enc = jt.encoder(str(tmp_path))
    files = [enc(jt.photo(203, 157, 3 + k), 90, s, bool(k % 2))
             for k, s in enumerate([(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (2, 4)])]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
    for name in ("q90_cmyk_h2v2.jpg", "q90_ycck.jpg", "q90_gray.jpg", "q90_rgb_adobe0.jpg"):
        with open(os.path.join(root, name), "rb") as fh:
            files.append(fh.read())
    items = []
    for data in files:
        frame = jpeg_dec.read_header(data)
        for scale in (1, 2, 4, 8):
            fw, fh = -(-frame.width * scale // 8), -(-frame.height * scale // 8)
            items.append((data, scale, (fw // 5 | 1, fh // 3 | 1, fw // 2, fh // 2 + 1)))
    for got in _host_decode(kernels, monkeypatch, items):
        assert got.rgb.ndim == 3
