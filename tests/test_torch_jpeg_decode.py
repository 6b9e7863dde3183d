"""The PyTorch package's JPEG decoder against the JAX package's native route.

The JAX package decodes JPEG with libjpeg-turbo through its native library
(``fc_jpeg_decode``, ``fc_jpeg_decode_roi``; ``flyimg_tpu/codecs/native/
fastcodec.cpp``), built here from the unmodified source by
``tests/jax_fastcodec.py``. The port decodes with its own reader
(``codecs/native/jpeg_reader.cpp``) and its kernels' plain versions on the
CPU (``codecs/jpeg_dec_plain.py``: K18's IDCTs, K19's upsampling and colour
conversion). Files come from ``tests/data/jpeg`` and from a small libjpeg
encoder of any layout (``tests/jpeg_test_files.py``).

Bound: max difference 0 everywhere (pixels, window offsets, frame sizes),
except the handler's answers (byte-equal, or where a resample of a window
runs, within PERF.md section 2's pixel bound: 1 level on at most 1e-4 of
values, compared through the o_png answer; each case says which).

Not covered, because libjpeg-turbo gives no answer to match: a window of a
2x4-sampled file at DCT scale 1/2 (its jpeg_crop_scanline narrows the
chroma the upsampler reads to half the columns it fills, so the rest of
each row is whatever its buffer held; its output changes from run to run:
ROADMAP.md Queue C 16).
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_test_files as jt
from jax_fastcodec import fastcodec, use_in_jax  # noqa: F401 (fixture)
from flyimg_tpu_torch.codecs import batch_jpeg_decode, batch_jpeg_encode, encode, jpeg_dec
from flyimg_tpu_torch.exceptions import ExecFailedException, UnsupportedMediaException

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
FIXTURES = sorted(os.path.basename(f) for f in glob.glob(os.path.join(DATA, "*.jpg")))
SCALES = (1, 2, 4, 8)
SAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (2, 4)]


@pytest.fixture(scope="module")
def native(fastcodec):  # noqa: F811
    return jt.Native(fastcodec.path)


@pytest.fixture(scope="module")
def enc(tmp_path_factory):
    reason = jt_missing()
    if reason:
        pytest.skip(reason)
    return jt.encoder(str(tmp_path_factory.mktemp("jpeg_encoder")))


def jt_missing():
    from jax_fastcodec import tool

    return tool.missing()


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _port(data: bytes, scale: int, roi=None):
    return jpeg_dec.decode(data, scale, roi, device="cpu")


def _assert_same(got, want):
    assert got is not None and want is not None
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_native(native, data: bytes, scale: int):
    """The port's decode of ``data`` equals fc_jpeg_decode's, or fails
    (ExecFailedException) where that call fails (a libjpeg error, not a
    warning)."""
    want = native.decode(data, scale)
    if want is None:
        with pytest.raises(ExecFailedException):
            _port(data, scale)
        return
    _assert_same(_port(data, scale).rgb, want)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", FIXTURES)
def test_every_fixture_at_every_scale_equals_the_native_decode(native, name, scale):
    data = _read(name)
    _assert_same(_port(data, scale).rgb, native.decode(data, scale))


@pytest.mark.parametrize("name", FIXTURES)
def test_native_route_fixture_files_are_the_port_s_decodes(name):
    """The stored native-route decodes (``<name>.native.s<k>.png``, written
    by tools/make_jpeg_fixtures.py with fc_jpeg_decode) are the port's, at
    every scale: the files the card's check holds K18 and K19 to."""
    data = _read(name)
    for scale in SCALES:
        path = os.path.join(DATA, f"{name[:-4]}.native.s{scale}.png")
        want = np.asarray(Image.open(path).convert("RGB"))
        _assert_same(_port(data, scale).rgb, want)


def test_native_route_window_fixtures_are_the_port_s_windows():
    with open(os.path.join(DATA, "reference.json")) as fh:
        windows = json.load(fh)["native_windows"]
    assert len(windows) >= 8
    for entry in windows:
        got = _port(_read(entry["source"]), entry["scale"], tuple(entry["request"]))
        want = np.asarray(Image.open(os.path.join(DATA, entry["file"])).convert("RGB"))
        _assert_same(got.rgb, want)
        assert list(got.offset) == [entry["out_x"], entry["out_y"]]
        assert list(got.frame_size) == [entry["full_w"], entry["full_h"]]


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", SAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_samplings_progressive_and_restarts_equal_the_native_decode(native, enc, sampling,
                                                                    progressive, restart):
    data = enc(jt.photo(97, 61, sampling[0] * 7 + sampling[1]), 85, sampling, progressive,
               restart)
    for scale in SCALES:
        _assert_same(_port(data, scale).rgb, native.decode(data, scale))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (203, 157)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_edge_sizes_equal_the_native_decode(native, enc, size):
    """1x1, 7x9, 17x33 and 203x157 (no MCU multiple at any sampling) at
    every sampling, gray too, baseline and progressive."""
    w, h = size
    for k, sampling in enumerate(SAMPLINGS):
        data = enc(jt.photo(w, h, k), 90, sampling, bool(k % 2), 2 * (k % 3))
        for scale in SCALES:
            _assert_same(_port(data, scale).rgb, native.decode(data, scale))
    gray = enc(jt.photo(w, h, 9)[..., 1], 80, (1, 1), True, 1)
    for scale in SCALES:
        _assert_same(_port(gray, scale).rgb, native.decode(gray, scale))


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("restart", [0, 4])
@pytest.mark.parametrize("fraction", [0.03, 0.1, 0.5, 0.93])
def test_truncated_file_equals_the_native_decode(native, enc, fraction, restart, progressive):
    """libjpeg-turbo's premature end of data: the image is answered, not an
    error. A baseline file's missing blocks are zero (mid-grey); a
    progressive file's coefficients not known to full precision are
    estimated from the DC values around each block (its block smoothing,
    with the rows past the last decoded one on the scan before), whole
    and in windows (whose left edge replicates the DC window)."""
    for k, sampling in enumerate([(2, 2), (1, 2), (2, 1), (1, 1)]):
        data = enc(jt.photo(203, 157, 5 + k), 90, sampling, progressive, restart)
        data = jt.truncate(data, fraction)
        for scale in SCALES:
            _assert_native(native, data, scale)
            fw, fh = -(-203 * scale // 8), -(-157 * scale // 8)
            roi = (fw // 3, fh // 4, fw // 2, fh // 2)
            want = native.decode_roi(data, scale, roi)
            if want is not None:
                got = _port(data, scale, roi)
                _assert_same(got.rgb, want[0])
                assert (got.offset, got.frame_size) == (want[1], want[2])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("layout", ["baseline", "restarts", "progressive"])
def test_corrupted_entropy_segment_equals_the_native_decode(native, enc, layout, seed):
    """Bytes replaced after the first scan's start: bad codes, lost sync,
    restart markers out of step and extreme coefficients, answered as
    libjpeg-turbo answers them (its SIMD IDCT saturating where it does); a
    progressive file's later marker segments may be hit too, and where
    libjpeg fails on one (a broken Huffman table) the port fails."""
    progressive = layout == "progressive"
    restart = 4 if layout == "restarts" else 0
    data = jt.corrupt(enc(jt.photo(120, 90, 5), 90, (2, 2), progressive, restart), seed)
    for scale in SCALES:
        _assert_native(native, data, scale)


def _windows(fw, fh):
    return {
        "whole": (0, 0, fw, fh),
        "top_left": (0, 0, fw // 2, fh // 2),
        "middle": (fw // 3, fh // 3, fw // 3, fh // 3),
        "bottom_right": (fw - 7, fh - 5, 7, 5),
        "past_the_edges": (-3, -2, fw + 9, 9),
        "one_pixel": (5, fh // 2, 1, 1),
        "right_strip": (fw // 2, 0, fw, 3),
        "full_width_band": (0, fh // 4, fw, fh // 4),
    }


@pytest.mark.parametrize("window", list(_windows(1, 1)))
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("sampling", [(2, 2), (1, 1), (2, 1), (1, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_windows_equal_the_native_roi_decode(native, enc, sampling, scale, window):
    """Pixels, origin (the left edge aligned down to the iMCU column) and
    scaled frame size as fc_jpeg_decode_roi gives them, baseline (its
    entropy decode stopped below the window) and progressive."""
    w, h = 203, 157
    fw, fh = -(-w * scale // 8), -(-h * scale // 8)
    roi = _windows(fw, fh)[window]
    for progressive in (False, True):
        data = enc(jt.photo(w, h, 3), 88, sampling, progressive, 5 * progressive)
        want = native.decode_roi(data, scale, roi)
        got = _port(data, scale, roi)
        _assert_same(got.rgb, want[0])
        assert (got.offset, got.frame_size) == (want[1], want[2])


def test_empty_window_fails_as_the_native_roi_decode(native, enc):
    data = enc(jt.photo(40, 30, 1), 90, (2, 2))
    for roi in [(40, 0, 5, 5), (0, 30, 5, 5), (-10, 0, 5, 5), (3, 3, 0, 4)]:
        assert native.decode_roi(data, 8, roi) is None
        assert _port(data, 8, roi) is None


def test_mixed_batch_equals_its_members_decoded_singly(enc):
    """Whole and window members of several layouts in ONE batch (one K18
    and one K19 launch) equal the same members decoded alone; a member
    whose decode fails fails alone."""
    files = [enc(jt.photo(61, 45, k), 90, s, k % 2 == 1, 3 * (k % 2))
             for k, s in enumerate(SAMPLINGS)] + [_read("q90_cmyk.jpg"), _read("q90_gray.jpg")]
    items = []
    for k, data in enumerate(files):
        items.append((data, 8, None))
        items.append((data, 4, (3, 2, 17, 11)))
        items.append((data, 2, None))
    items.insert(5, (b"\xff\xd8\xff\xd9", 8, None))
    got = jpeg_dec.decode_batch(items, device="cpu")
    assert isinstance(got[5], ExecFailedException)
    for (data, scale, roi), out in zip(items, got):
        if data == b"\xff\xd8\xff\xd9":
            continue
        alone = jpeg_dec.decode(data, scale, roi, device="cpu")
        np.testing.assert_array_equal(out.rgb, alone.rgb)
        assert (out.offset, out.frame_size) == (alone.offset, alone.frame_size)


def _stub_frame(w, h):
    """A 4:2:0 YCbCr frame's header as the reader reports it (no file)."""
    frame = jpeg_dec.FlJpegFrame()
    frame.width, frame.height, frame.ncomp, frame.color = w, h, 3, 1
    frame.max_h = frame.max_v = 2
    frame.mcus_x, frame.mcus_y = -(-w // 16), -(-h // 16)
    frame.single_scan = 1
    for c, f in enumerate((2, 1, 1)):
        frame.comp_h[c] = frame.comp_v[c] = f
        frame.blocks_w[c], frame.blocks_h[c] = -(-w * f // 16), -(-h * f // 16)
        frame.alloc_w[c], frame.alloc_h[c] = frame.mcus_x * f, frame.mcus_y * f
    return frame


def test_tables_hold_offsets_past_2_31():
    """A codec group of 24 whole 12000x9000 decodes (a 108-megapixel frame
    each): the batch's plane bytes, pixels and output bytes pass 2^31, and
    every offset in K18's segment table and K19's member table is the
    exact 64-bit sum, with no wrap."""
    plans = [jpeg_dec.plan_member(_stub_frame(12000, 9000), 8) for _ in range(24)]
    starts, block = [], 0
    for pl in plans:
        starts.append(block)
        block += jpeg_dec.coef_count(pl.frame) // 64
    segs, mems, plane_bytes, out_bytes, outs, *_ = jpeg_dec.build_tables(plans, starts)
    assert segs.dtype == mems.dtype == torch.int64
    plain = jpeg_dec.plain
    plane = first_block = out = pixel = 0
    for i, pl in enumerate(plans):
        assert int(mems[i, plain.MEM_OUT]) == out and int(mems[i, plain.MEM_FIRST]) == pixel
        assert outs[i] == (out, 12000, 9000)
        for c, cp in enumerate(pl.comps):
            row = segs[3 * i + c]
            assert int(row[plain.SEG_OUT]) == plane == int(mems[i, 8 + 8 * c + plain.COMP_PLANE])
            assert int(row[plain.SEG_FIRST]) == first_block
            assert int(row[plain.SEG_COEF]) >= starts[i]
            plane += cp.nbx * cp.ssize * cp.nby * cp.ssize
            first_block += cp.nbx * cp.nby
        out += 12000 * 9000 * 3
        pixel += 12000 * 9000
    assert (plane_bytes, out_bytes) == (plane, out)
    assert plane_bytes > 2 ** 31 and out_bytes > 2 ** 32 and pixel > 2 ** 31
    assert int(segs[-1, plain.SEG_OUT]) > 2 ** 31 and int(mems[-1, plain.MEM_OUT]) > 2 ** 32
    assert int(mems[-1, plain.MEM_FIRST]) > 2 ** 31


def test_batch_runner_follows_the_jax_runner_s_contract(enc):
    """``batch_jpeg_decode`` (the codec batcher's runner): whole members as
    oriented arrays, window members as (rgb, origin, frame size) with an
    (x0, y0, x1, y1) request, None for a member that fails."""
    data = enc(jt.photo(80, 60, 2), 90, (2, 2))
    out = batch_jpeg_decode([(data, 8, None), (data, 8, (10, 5, 50, 40)), (b"junk", 8, None)],
                            device="cpu")
    np.testing.assert_array_equal(out[0], _port(data, 8).rgb)
    window = _port(data, 8, (10, 5, 40, 35))
    np.testing.assert_array_equal(out[1][0], window.rgb)
    assert out[1][1:] == (window.offset, window.frame_size)
    assert out[2] is None


def test_arithmetic_coding_is_refused_by_name(native, enc):
    """An arithmetic-coded file (SOF9) is no longer refused: it decodes as
    libjpeg-turbo decodes it."""
    data = enc(jt.photo(32, 24, 1), 90, (2, 2), arith=True)
    assert data[data.index(b"\xff\xc9"):][:2] == b"\xff\xc9"
    _assert_same(_port(data, 8).rgb, native.decode(data, 8))


ARITH_SAMPLINGS = [None, (1, 1), (2, 1), (2, 2)]


def _arith_file(enc, sampling, progressive, restart, seed=4, size=(97, 61), dac=None):
    pixels = jt.photo(size[0], size[1], seed)
    if sampling is None:
        return enc(pixels[..., 1], 85, (1, 1), progressive, restart, arith=True, dac=dac)
    return enc(pixels, 85, sampling, progressive, restart, arith=True, dac=dac)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("sampling", ARITH_SAMPLINGS,
                         ids=lambda s: "gray" if s is None else f"{s[0]}x{s[1]}")
def test_arithmetic_files_equal_the_native_decode(native, enc, sampling, progressive, restart):
    """Arithmetic-coded files, sequential (SOF9) and progressive (SOF10),
    gray, 4:4:4, 4:2:2 and 4:2:0, with and without restart markers: every
    DCT scale and three windows equal fc_jpeg_decode and
    fc_jpeg_decode_roi."""
    data = _arith_file(enc, sampling, progressive, restart)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    for scale in SCALES:
        _assert_same(_port(data, scale).rgb, native.decode(data, scale))
        fw, fh = -(-97 * scale // 8), -(-61 * scale // 8)
        for name in ("middle", "bottom_right", "full_width_band"):
            roi = _windows(fw, fh)[name]
            want = native.decode_roi(data, scale, roi)
            got = _port(data, scale, roi)
            _assert_same(got.rgb, want[0])
            assert (got.offset, got.frame_size) == (want[1], want[2])


@pytest.mark.parametrize("dac", [(0, 0, 1), (2, 5, 20), (15, 15, 63)],
                         ids=["low", "mid", "high"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_arithmetic_conditioning_tables_equal_the_native_decode(native, enc, progressive, dac):
    """A DAC marker's L, U and Kx change the statistics bins a value is
    coded in; the decode follows them as libjpeg-turbo does."""
    data = _arith_file(enc, (2, 2), progressive, 2, seed=7, dac=dac)
    assert b"\xff\xcc" in data
    for scale in SCALES:
        _assert_same(_port(data, scale).rgb, native.decode(data, scale))


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("restart", [0, 4])
@pytest.mark.parametrize("fraction", [0.03, 0.1, 0.5, 0.93])
def test_truncated_arithmetic_file_equals_the_native_decode(native, enc, fraction, restart,
                                                           progressive):
    """A cut arithmetic-coded file: the coder reads zero data to the end of
    each scan (no block is left zero on purpose, as Huffman's are), and a
    progressive file then gets the block smoothing; whole and windows."""
    for k, sampling in enumerate([(2, 2), (1, 1), None]):
        data = jt.truncate(_arith_file(enc, sampling, progressive, restart, seed=11 + k,
                                       size=(203, 157)), fraction)
        for scale in SCALES:
            _assert_native(native, data, scale)
            fw, fh = -(-203 * scale // 8), -(-157 * scale // 8)
            roi = (fw // 3, fh // 4, fw // 2, fh // 2)
            want = native.decode_roi(data, scale, roi)
            if want is not None:
                got = _port(data, scale, roi)
                _assert_same(got.rgb, want[0])
                assert (got.offset, got.frame_size) == (want[1], want[2])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("layout", ["sof9", "sof9_restarts", "sof10"])
def test_corrupted_arithmetic_segment_equals_the_native_decode(native, enc, layout, seed):
    """Bytes replaced inside arithmetic-coded data: wrong decisions, bad
    codes (a magnitude or spectral overflow stops the coder to the next
    restart marker) and restart markers out of step, as libjpeg-turbo
    answers them."""
    progressive = layout == "sof10"
    restart = 4 if layout == "sof9_restarts" else 0
    data = jt.corrupt(_arith_file(enc, (2, 2), progressive, restart, seed=5, size=(120, 90)),
                      seed)
    for scale in SCALES:
        _assert_native(native, data, scale)


INGEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ingest")


@pytest.mark.parametrize("scale", [8, 2])
def test_arithmetic_fixture_equals_its_reference(scale):
    """The committed 2048x1536 arithmetic progressive JPEG (chip_smoke.py
    phase 16's) decodes to the SHA-256 its reference.json holds: the JAX
    package's fc_jpeg_decode at 1/1 and 1/4 (tools/make_ingest_fixtures.py)."""
    import hashlib

    with open(os.path.join(INGEST, "reference.json")) as fh:
        want = json.load(fh)["arith_progressive_2048x1536.jpg"][f"s{scale}"]
    with open(os.path.join(INGEST, "arith_progressive_2048x1536.jpg"), "rb") as fh:
        data = fh.read()
    assert data[data.index(b"\xff\xca"):][:2] == b"\xff\xca"
    rgb = _port(data, scale).rgb
    assert list(rgb.shape) == want["shape"]
    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest() == want["sha256"]


@pytest.mark.parametrize("marker", [0xCB, 0xCD, 0xCE, 0xCF],
                         ids=["sof11", "sof13", "sof14", "sof15"])
def test_lossless_and_hierarchical_arithmetic_frames_are_refused_by_name(native, enc, marker):
    """SOF11 (lossless) and SOF13-15 (hierarchical) stay refused, as
    libjpeg's 8-bit build refuses them."""
    data = bytearray(enc(jt.photo(24, 16, 2), 90, (2, 2), arith=True))
    at = data.index(b"\xff\xc9")
    data[at + 1] = marker
    assert native.decode(bytes(data), 8) is None
    with pytest.raises(UnsupportedMediaException, match="lossless or hierarchical"):
        _port(bytes(data), 8)


def test_arithmetic_and_huffman_members_share_one_batch(enc):
    """Arithmetic and Huffman members in one batch (one K18 and one K19
    launch) equal the same members decoded alone."""
    items = []
    for k, sampling in enumerate(ARITH_SAMPLINGS):
        for arith in (False, True):
            pixels = jt.photo(61, 45, k)
            pixels = pixels[..., 0] if sampling is None else pixels
            data = enc(pixels, 90, sampling or (1, 1), k % 2 == 1, 2, arith=arith)
            items += [(data, 8, None), (data, 4, (3, 2, 17, 11))]
    got = jpeg_dec.decode_batch(items, device="cpu")
    for (data, scale, roi), out in zip(items, got):
        alone = jpeg_dec.decode(data, scale, roi, device="cpu")
        np.testing.assert_array_equal(out.rgb, alone.rgb)


@pytest.mark.parametrize("marker,precision", [(0xC1, 8), (0xC3, 8), (0xC0, 12)],
                         ids=["extended_sequential", "lossless", "12_bit"])
def test_frame_kinds_answer_as_the_native_decode(native, enc, marker, precision):
    """An extended sequential frame (SOF1) decodes as a baseline one; a
    lossless frame (SOF3) and a 12-bit one fail in libjpeg's 8-bit build
    and are refused by name (UnsupportedMediaException)."""
    data = bytearray(enc(jt.photo(24, 16, 2), 90, (2, 2)))
    at = data.index(b"\xff\xc0")
    data[at + 1], data[at + 4] = marker, precision
    data = bytes(data)
    want = native.decode(data, 8)
    if marker == 0xC1:
        _assert_same(_port(data, 8).rgb, want)
        return
    assert want is None
    with pytest.raises(UnsupportedMediaException):
        _port(data, 8)


def test_a_non_jpeg_and_an_empty_image_fail_as_decode_errors():
    for data in (b"not a jpeg", b"\xff\xd8\xff\xd9"):
        with pytest.raises(ExecFailedException):
            _port(data, 8)


# ---------------------------------------------------------------------------
# the handler, end to end
# ---------------------------------------------------------------------------

#: option strings of JPEG-source requests, and how the answers compare:
#: "bytes" byte-equal, "exact" the same pixels (a PNG of the decode itself:
#: the PNG writers differ), "pixels" within the pixel bound through o_png
HANDLER_CASES = {
    "w_300,h_250,c_1": "pixels",
    "w_300,h_250,c_1,smc_1": "pixels",
    "e_1,p1x_100,p1y_100,p2x_900,p2y_700": "pixels",
    "r_30": "pixels",
    "w_2000,pns_0": "pixels",
    "o_png": "exact",
    "o_jpg": "bytes",
}


def _handlers(tmp_path, monkeypatch, fastcodec, codec_batcher):  # noqa: F811
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.handler import ImageHandler

    use_in_jax(monkeypatch, fastcodec)
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"), "tmp_dir": str(tmp_path / "jt"),
                              "decode_roi": True})
    jhandler = JImageHandler(make_storage(jparams), jparams)
    codec = BatchController(device="cpu", max_batch=8, deadline_ms=1.0) if codec_batcher \
        else None
    port = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                       "tmp_dir": str(tmp_path / "t"), "decode_roi": True}),
                        device="cpu", codec_batcher=codec)
    return jhandler, port, codec


def _pixels(content: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(int)


@pytest.mark.parametrize("codec_batcher", [False, True], ids=["single", "codec_group"])
@pytest.mark.parametrize("opts", list(HANDLER_CASES))
def test_handler_jpeg_source_answers_match_the_jax_handler(tmp_path, monkeypatch,
                                                           fastcodec, opts,  # noqa: F811
                                                           codec_batcher):
    """The port's handler on the CPU (ROI decode on, the single decode or
    the codec batcher's decode and encode groups) against the JAX handler
    on its native route: byte-equal answers where HANDLER_CASES says
    "bytes", the same pixels where it says "exact"; elsewhere the same
    name and size and, through the o_png answer of the same request, at
    most 1 level on at most 1e-4 of values (PERF.md section 2's bound; the
    device resamples differ by float rounding, not the decode). The
    extract decodes a window (64 % of the frame); the crops of this 4:3
    source keep 90 % of it, past the 80 % a window may cover, so they
    decode whole."""
    src = os.path.join(DATA, "photo1000x750_rst.jpg")
    jhandler, port, codec = _handlers(tmp_path, monkeypatch, fastcodec, codec_batcher)
    try:
        got = port.process_image(opts, src)
        want = jhandler.process_image(opts, src)
        assert got.spec.name == want.spec.name
        if HANDLER_CASES[opts] == "bytes":
            assert got.content == want.content
            return
        if HANDLER_CASES[opts] == "exact":
            np.testing.assert_array_equal(_pixels(got.content), _pixels(want.content))
            return
        a = _pixels(port.process_image(opts + ",o_png", src).content)
        b = _pixels(jhandler.process_image(opts + ",o_png", src).content)
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
        assert _pixels(got.content).shape == _pixels(want.content).shape
    finally:
        if codec is not None:
            codec.close()


def test_handler_decodes_a_window_and_names_the_mode(tmp_path, monkeypatch,
                                                    fastcodec):  # noqa: F811
    """An extract or a narrow crop of a 4:3 source decodes a window
    (``timings["decode_roi"]``), the crop at the hint's scale (1/2) too; a
    whole-frame resize decodes prescaled (``decode_prescale``); an
    EXIF-rotated source never a window."""
    _, port, _ = _handlers(tmp_path, monkeypatch, fastcodec, False)
    src = os.path.join(DATA, "photo1000x750_rst.jpg")
    assert "decode_roi" in port.process_image("e_1,p1x_100,p1y_100,p2x_900,p2y_700",
                                              src).timings
    assert "decode_roi" in port.process_image("w_60,h_100,c_1", src).timings
    assert "decode_prescale" in port.process_image("w_100", src).timings
    rotated = os.path.join(DATA, "q90_420_orient6.jpg")
    assert "decode_roi" not in port.process_image("w_60,h_60,c_1", rotated).timings


@pytest.mark.parametrize("mozjpeg", [False, True], ids=["moz_0", "moz_1"])
def test_encode_group_bytes_equal_single_encodes(mozjpeg):
    """``batch_jpeg_encode`` (the codec batcher's encode group: K17 or K16
    once for the group) gives each member its single encode's bytes."""
    frames = [jt.photo(33 + 7 * k, 21 + 5 * k, k) for k in range(4)]
    for sampling in [(1, 1), (2, 2)]:
        got = batch_jpeg_encode([(f, 80, sampling, mozjpeg) for f in frames], device="cpu")
        sf = f"{sampling[0]}x{sampling[1]}"
        want = [encode(f, "jpg", quality=80, mozjpeg=mozjpeg, sampling_factor=sf, device="cpu")
                for f in frames]
        assert got == want
