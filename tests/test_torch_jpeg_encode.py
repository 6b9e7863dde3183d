"""The port's JPEG encoder (flyimg_tpu_torch/codecs/jpeg_enc.py) against the
JAX package's, on the CPU.

- ``encode_trellis`` (kernel K16's plain version + the host writer)
  byte-equal to the JAX package's ``fc_jpeg_encode_trellis``,
  ``encode_plain`` (K17's) to its ``fc_jpeg_encode`` and ``encode_cmyk`` to
  its handler's ``_encode_cmyk_jpeg`` (Pillow), over seeded images of
  ragged sizes, qualities and every luma sampling factor libjpeg takes.
  The native encoders come from the unmodified ``fastcodec.cpp`` built
  into a temporary directory (``tests/jax_fastcodec.py``; skipped, with
  the reason, where g++ or libjpeg's headers are missing).
- The plain versions' pieces against numpy transcriptions of the C++ and
  libjpeg code they repeat (``fdct8x8``, ``trellis_ac``,
  ``jpeg_fdct_islow`` with libjpeg's rounding division), libjpeg-turbo's
  reciprocal quantization against that division over its whole domain,
  and a flat block coding its DC alone.
- The fixtures of ``tests/data/jpeg_enc`` (what ``chip_smoke.py`` holds the
  kernels' encodes to on a card) are what
  ``tools/make_jpeg_encode_fixtures.py`` writes, and the port's encodes
  of their source are those files.
- The edge frames of ``flyimg_tpu_torch.testing.jpeg_frames`` (flat, 0/255
  checkerboards at q100, q1, 1x1/8x8/9x9, a 1920x1080 frame at 4:2:0),
  the ones ``chip_smoke.py`` holds the kernels to their plain versions
  on: each plain version's encode byte-equal to the JAX package's.
- K17's 32-bit arithmetic: every intermediate of ``jpeg_fdct_islow``
  carried as a linear form in the 64 samples stays under 2^31, and the
  reciprocal quantization's product under 2^32.
- The handler: JPEG answers (``moz_0``/``moz_1``, every factor nvJPEG
  lacks, ``clsp_CMYK``, ``st_0``) byte-equal to the JAX handler's with
  its native library in place.

Bound: exact everywhere (bytes, coefficients, f32 values).
"""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.service.handler import _encode_cmyk_jpeg
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables, png
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.testing import jpeg_frames
from jax_fastcodec import fastcodec, tool, use_in_jax  # noqa: F401

torch.set_num_threads(1)

SIZES = [(1, 1), (7, 5), (17, 9), (300, 250), (301, 251)]          # (w, h)
QUALITIES = [1, 25, 50, 75, 90, 95, 100]
FACTORS = list(tool.FACTORS)
SOME_FACTORS = [(1, 1), (2, 2), (1, 3), (4, 2)]
_CMYK_SPEC = type("Spec", (), {"extension": "jpg"})()


def _ids(values):
    return ["x".join(map(str, v)) for v in values]


@functools.lru_cache(maxsize=None)
def _image(w, h):
    rng = np.random.default_rng(w * 1000 + h)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (11.0 + 7 * c) + c) * np.cos(xx / 23.0 - c)
                    for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    img[: h // 3, : w // 4] = (250, 3, 128)           # saturated, sharp-edged
    img.setflags(write=False)
    return img


# ---------------------------------------------------------------------------
# bytes against the JAX package's encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampling", FACTORS, ids=_ids(FACTORS))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=_ids(SIZES))
def test_encode_trellis_matches_jax(fastcodec, size, quality, sampling):
    img = _image(*size)
    assert jpeg_enc.encode_trellis(img, quality, sampling, device="cpu") == \
        fastcodec.trellis(img, quality, sampling)


@pytest.mark.parametrize("sampling", SOME_FACTORS, ids=_ids(SOME_FACTORS))
@pytest.mark.parametrize("size", SIZES, ids=_ids(SIZES))
def test_encode_trellis_baseline_matches_jax(fastcodec, size, sampling):
    """progressive off: one baseline scan with optimized tables."""
    img = _image(*size)
    assert jpeg_enc.encode_trellis(img, 75, sampling, progressive=False, device="cpu") == \
        fastcodec.trellis(img, 75, sampling, progressive=False)


@pytest.mark.parametrize("sampling", FACTORS, ids=_ids(FACTORS))
@pytest.mark.parametrize("quality", [1, 90, 100])
@pytest.mark.parametrize("size", SIZES, ids=_ids(SIZES))
def test_encode_plain_matches_jax(fastcodec, size, quality, sampling):
    """moz_0: fc_jpeg_encode with the standard tables, one baseline scan."""
    img = _image(*size)
    assert jpeg_enc.encode_plain(img, quality, sampling=sampling, device="cpu") == \
        fastcodec.encode(img, quality, sampling)


@pytest.mark.parametrize("sampling", SOME_FACTORS, ids=_ids(SOME_FACTORS))
@pytest.mark.parametrize("optimize,progressive", [(True, False), (True, True), (False, True)])
def test_encode_plain_optimized_and_progressive_match_jax(fastcodec, optimize, progressive,
                                                          sampling):
    """fc_jpeg_encode's other modes (progressive always optimizes)."""
    img = _image(301, 251)
    assert jpeg_enc.encode_plain(img, 75, optimize, progressive, sampling, device="cpu") == \
        fastcodec.encode(img, 75, sampling, optimize, progressive)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [1, 50, 90, 100])
@pytest.mark.parametrize("size", SIZES, ids=_ids(SIZES))
def test_encode_cmyk_matches_jax(size, quality, optimize):
    img = _image(*size)
    got = jpeg_enc.encode_cmyk(img, quality, optimize, device="cpu")
    assert got == _encode_cmyk_jpeg(img, _CMYK_SPEC, quality, optimize)
    assert got[2:4] == b"\xff\xee" and b"\xff\xc0\x00\x14\x08" in got  # Adobe, 4 components


EDGE_CASES = jpeg_frames.CASES
EDGE_IDS = [f"{name}-q{q}-{s[0]}x{s[1]}" for name, q, s in EDGE_CASES]
EDGE_CMYK = sorted({(name, q) for name, q, _ in EDGE_CASES})


@pytest.mark.parametrize("name,quality,sampling", EDGE_CASES, ids=EDGE_IDS)
def test_edge_frames_trellis_match_jax(fastcodec, name, quality, sampling):
    """moz_1 on the frames chip_smoke.py holds K16 to its plain version on."""
    img = jpeg_frames.frame(name)
    assert jpeg_enc.encode_trellis(img, quality, sampling, device="cpu") == \
        fastcodec.trellis(img, quality, sampling)


@pytest.mark.parametrize("name,quality,sampling", EDGE_CASES, ids=EDGE_IDS)
def test_edge_frames_plain_match_jax(fastcodec, name, quality, sampling):
    """moz_0 on the frames chip_smoke.py holds K17 to its plain version on."""
    img = jpeg_frames.frame(name)
    assert jpeg_enc.encode_plain(img, quality, sampling=sampling, device="cpu") == \
        fastcodec.encode(img, quality, sampling)


@pytest.mark.parametrize("name,quality", EDGE_CMYK, ids=[f"{n}-q{q}" for n, q in EDGE_CMYK])
def test_edge_frames_cmyk_match_jax(name, quality):
    """clsp_CMYK (K17 on four planes) on the same frames."""
    img = jpeg_frames.frame(name)
    assert jpeg_enc.encode_cmyk(img, quality, device="cpu") == \
        _encode_cmyk_jpeg(img, _CMYK_SPEC, quality, False)


def test_invalid_sampling_factors_fail_as_the_jax_encoder(fastcodec):
    img = _image(17, 9)
    for sampling in [(0, 1), (5, 1), (3, 3), (4, 4), (1, 5)]:
        with pytest.raises(Exception, match="sampling"):
            jpeg_enc.encode_trellis(img, 90, sampling, device="cpu")
        with pytest.raises(Exception, match="sampling"):
            jpeg_enc.encode_plain(img, 90, sampling=sampling, device="cpu")
        with pytest.raises(RuntimeError):
            fastcodec.trellis(img, 90, sampling)


# ---------------------------------------------------------------------------
# the plain versions' pieces
# ---------------------------------------------------------------------------


def _np_fdct8x8(block, cos):
    """trellis::fdct8x8, float32 scalars in its loop order."""
    f32 = np.float32
    tmp = np.zeros(64, np.float32)
    out = np.zeros(64, np.float32)
    for y in range(8):
        for u in range(8):
            s = f32(0)
            for x in range(8):
                s = f32(s + f32(block[y * 8 + x] * cos[u, x]))
            tmp[y * 8 + u] = s
    for u in range(8):
        for v in range(8):
            s = f32(0)
            for y in range(8):
                s = f32(s + f32(tmp[y * 8 + u] * cos[v, y]))
            out[v * 8 + u] = s
    return out


def _np_trellis_ac(cz, qz, lrate, lzrl, leob):
    """trellis::trellis_ac, float32 scalars in its loop order."""
    f32 = np.float32
    prefix = [f32(0)] * 65
    for k in range(1, 64):
        prefix[k + 1] = f32(prefix[k] + f32(cz[k] * cz[k]))
    best, prev_nz, chosen = [f32(1e30)] * 64, [0] * 64, [0] * 64
    w, wj = [f32(0)] * 64, [0] * 64
    for k in range(1, 64):
        a, q = f32(abs(cz[k])), f32(qz[k])
        v0 = min(int(f32(f32(a / q) + f32(0.5))), 1023)
        if v0 >= 1:
            mmax = min(k - 1, 15)
            for dv in (0, 1):
                v = v0 - dv
                if v < 1:
                    break
                size = int(v).bit_length()
                d = f32(a - f32(f32(v) * q))
                fixed = f32(f32(d * d) + prefix[k])
                bc, bm = f32(w[k - 1] + lrate[size][0]), 0
                for m in range(1, mmax + 1):
                    c = f32(w[k - 1 - m] + lrate[size][m])
                    if c < bc:
                        bc, bm = c, m
                cost = f32(fixed + bc)
                if cost < best[k]:
                    best[k], prev_nz[k], chosen[k] = cost, wj[k - 1 - bm], v
        g = f32(best[k] - prefix[k + 1]) if best[k] < f32(1e29) else f32(1e30)
        if k >= 16 and f32(w[k - 16] + lzrl) < g:
            w[k], wj[k] = f32(w[k - 16] + lzrl), wj[k - 16]
        else:
            w[k], wj[k] = g, k
    total, last = f32(prefix[64] + leob), 0
    for k in range(1, 64):
        if best[k] >= f32(1e29):
            continue
        cost = f32(f32(best[k] + f32(prefix[64] - prefix[k + 1])) + (leob if k < 63 else f32(0)))
        if cost < total:
            total, last = cost, k
    out = np.zeros(64, np.int64)
    k = last
    while k > 0:
        out[k] = -chosen[k] if cz[k] < 0 else chosen[k]
        k = prev_nz[k]
    return out


def _blocks_of(img, quality, sampling):
    """(zigzag f32 DCT blocks of each component, as trellis_plain computes
    them, and the component of each)."""
    params = jpeg_tables.trellis_params(quality)
    h, w = img.shape[:2]
    dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(sampling))
    cos = torch.tensor(params["cos"])
    out = []
    for c, plane in enumerate(jpeg_plain.trellis_planes(torch.tensor(img), sampling)):
        bw, bh = dims[c]
        samples = jpeg_plain._replicate(plane, bh * 8, bw * 8) - 128.0
        blocks = jpeg_plain._blocks(samples, bw, bh)
        out.append((blocks, jpeg_plain._to_zigzag(jpeg_plain.fdct8x8_plain(blocks, cos))))
    return params, out


def test_fdct8x8_plain_is_the_jax_transcription():
    params, comps = _blocks_of(_image(17, 9), 90, (2, 1))
    for blocks, cz in comps:
        nat = jpeg_plain.fdct8x8_plain(blocks, torch.tensor(params["cos"])).numpy()
        for b in range(blocks.shape[0]):
            want = _np_fdct8x8(blocks[b].reshape(64).numpy(), params["cos"])
            np.testing.assert_array_equal(nat[b], want)


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_trellis_ac_plain_is_the_jax_transcription(quality):
    params, comps = _blocks_of(_image(17, 9), quality, (1, 1))
    for c, (_blocks, cz) in enumerate(comps):
        t = 0 if c == 0 else 1
        got = jpeg_plain.trellis_ac_plain(
            cz, torch.tensor(params["q"][t]), torch.tensor(params["lrate"][t]),
            torch.tensor(params["lzrl"][t]), torch.tensor(params["leob"][t])).numpy()
        for b in range(cz.shape[0]):
            want = _np_trellis_ac(cz[b].numpy(), params["q"][t], params["lrate"][t],
                                  params["lzrl"][t], params["leob"][t])
            np.testing.assert_array_equal(got[b, 1:], want[1:])


def _np_islow(block):
    """jfdctint.c jpeg_fdct_islow on an int64 [64] block (natural order)."""
    d = block.astype(np.int64).copy()

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    for final, idx in ((False, [[r * 8 + x for x in range(8)] for r in range(8)]),
                       (True, [[y * 8 + c for y in range(8)] for c in range(8)])):
        shift = 15 if final else 11
        for ix in idx:
            v = [int(d[i]) for i in ix]
            t0, t7, t1, t6 = v[0] + v[7], v[0] - v[7], v[1] + v[6], v[1] - v[6]
            t2, t5, t3, t4 = v[2] + v[5], v[2] - v[5], v[3] + v[4], v[3] - v[4]
            t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
            o = [0] * 8
            o[0] = descale(t10 + t11, 2) if final else (t10 + t11) << 2
            o[4] = descale(t10 - t11, 2) if final else (t10 - t11) << 2
            z1 = (t12 + t13) * 4433
            o[2] = descale(z1 + t13 * 6270, shift)
            o[6] = descale(z1 + t12 * -15137, shift)
            z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
            z5 = (z3 + z4) * 9633
            t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
            z1, z2 = z1 * -7373, z2 * -20995
            z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
            o[7] = descale(t4 + z1 + z3, shift)
            o[5] = descale(t5 + z2 + z4, shift)
            o[3] = descale(t6 + z2 + z3, shift)
            o[1] = descale(t7 + z1 + z4, shift)
            for i, val in zip(ix, o):
                d[i] = val
    return d


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_fdct_islow_plain_is_jfdctint_and_libjpeg_s_division(quality):
    """K17's plain version: jpeg_fdct_islow, then libjpeg's quantization as
    the rounding division (|t| + 4q) // 8q with the sign put back."""
    rng = np.random.default_rng(quality)
    plane = rng.integers(0, 256, (24, 16), dtype=np.uint8)
    plane[8:16] = 255
    plane[16:, :8] = 0
    table = jpeg_tables.build_qtable(quality, jpeg_tables.LUMA_Q)
    got = jpeg_plain.fdct_islow_plain(torch.from_numpy(plane), table).numpy()
    zz = list(jpeg_tables.ZIGZAG)
    for b in range(6):
        by, bx = divmod(b, 2)
        block = plane[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8].reshape(64).astype(np.int64) - 128
        coef = _np_islow(block)
        d = np.array(table, np.int64) * 8
        want = np.sign(coef) * ((np.abs(coef) + d // 2) // d)
        np.testing.assert_array_equal(got[b], want[zz])


def test_reciprocal_quantization_is_libjpeg_s_division():
    """libjpeg-turbo's reciprocal, correction and shift give libjpeg's
    rounding division for every divisor q * 8 (q 1..255) and every
    magnitude a 16-bit DCT coefficient can take."""
    t = np.arange(0, 1 << 15, dtype=np.int64)
    for first in range(1, 256, 64):
        table = [min(q, 255) for q in range(first, first + 64)]
        div = jpeg_plain.quant_divisors(table).numpy()
        for i, q in enumerate(table):
            recip, corr, shift = (int(v) for v in div[:, i])
            np.testing.assert_array_equal(((t + corr) * recip) >> shift,
                                          (t + 4 * q) // (8 * q), err_msg=f"q {q}")
            # K17 forms the product in unsigned 32 bits
            assert int(((t + corr) * recip).max()) < 2 ** 32, f"q {q}"


class _Form:
    """An integer intermediate of jpeg_fdct_islow as a linear form in the
    block's 64 samples plus the rounding slack of the descales before it;
    every form made is checked against the largest magnitude seen."""

    peak = 0.0

    def __init__(self, coef, slack=0.0):
        self.coef, self.slack = coef, slack
        _Form.peak = max(_Form.peak, self.bound())

    def bound(self, extra=0.0):
        return 128.0 * float(np.abs(self.coef).sum()) + self.slack + extra

    def __add__(self, o):
        return _Form(self.coef + o.coef, self.slack + o.slack)

    def __sub__(self, o):
        return _Form(self.coef - o.coef, self.slack + o.slack)

    def __mul__(self, k):
        return _Form(self.coef * k, self.slack * abs(k))

    def descale(self, n):
        # (x + 2^(n-1)) >> n: the sum before the shift is an intermediate too,
        # and the shift is x / 2^n within 0.5
        _Form.peak = max(_Form.peak, self.bound(2.0 ** (n - 1)))
        return _Form(self.coef / 2 ** n, self.slack / 2 ** n + 0.5)


def _islow_forms(d, final):
    """jfdctint.c's pass over 8 forms, in its operations' order."""
    shift = 15 if final else 11
    t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o = [None] * 8
    o[0] = (t10 + t11).descale(2) if final else (t10 + t11) * 4
    o[4] = (t10 - t11).descale(2) if final else (t10 - t11) * 4
    z1 = (t12 + t13) * 4433
    o[2] = (z1 + t13 * 6270).descale(shift)
    o[6] = (z1 + t12 * -15137).descale(shift)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    p1, p2 = z1 * -7373, z2 * -20995
    p3, p4 = z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = (t4 * 2446 + p1 + p3).descale(shift)
    o[5] = (t5 * 16819 + p2 + p4).descale(shift)
    o[3] = (t6 * 25172 + p2 + p3).descale(shift)
    o[1] = (t7 * 12299 + p1 + p4).descale(shift)
    return o


def test_islow_intermediates_fit_in_32_bits():
    """K17 runs jpeg_fdct_islow in 32-bit integers: every intermediate of
    both passes, carried as a linear form in the 64 samples (each in
    [-128, 127]) with 0.5 of slack a descale, stays below 2^31; the
    outputs stay below 2^15, the domain the quantization is exact on."""
    _Form.peak = 0.0
    samples = [_Form(np.eye(64)[i]) for i in range(64)]
    rows = [_islow_forms(samples[r * 8:r * 8 + 8], final=False) for r in range(8)]
    cols = [_islow_forms([rows[y][u] for y in range(8)], final=True) for u in range(8)]
    peak = _Form.peak
    assert peak < 2 ** 31 / 6, peak      # the margin K17's source note states
    assert peak <= 343_982_080, peak
    assert max(f.bound() for col in cols for f in col) < 2 ** 15


def test_divisor_words_put_each_column_s_divisors_side_by_side():
    """K17's divisor buffer: word [t][kind][c][v] is divisor_rows' entry
    for natural index v * 8 + c of table t."""
    tables = jpeg_tables.qtables(37)
    words = jpeg_enc.divisor_words(tables)
    assert words.shape == (2, 3, 8, 8) and words.dtype == np.uint32 and words.flags.c_contiguous
    for t, table in enumerate(tables):
        rows = jpeg_plain.divisor_rows(tuple(table))
        for kind in range(3):
            for n in range(64):
                assert words[t, kind, n % 8, n // 8] == rows[kind][n]


def test_ptxas_report_reads_each_function_s_line():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114trellis_kernelEv' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_114trellis_kernelEv\n"
           "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 72 registers, used 1 barriers, 23312 bytes smem\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_111fdct_kernelEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, 400 bytes cmem[0]\n")
    report = cuda_build.ptxas_report(log)
    assert report == {
        "_ZN12_GLOBAL__N_114trellis_kernelEv": {"registers": 72, "stack": 16,
                                                 "spill_stores": 4, "spill_loads": 8},
        "_ZN12_GLOBAL__N_111fdct_kernelEv": {"registers": 40, "stack": 0,
                                             "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.parametrize("value", [0, 77, 128, 255])
def test_flat_block_gives_dc_only(value):
    img = np.full((16, 24, 3), value, np.uint8)
    for coef in (jpeg_plain.trellis_plain(torch.tensor(img), 90, (1, 1)),
                 jpeg_enc.fdct_coefficients(
                     jpeg_plain.grid_planes(torch.tensor(img), (1, 1)),
                     jpeg_tables.qtables(90), (0, 1, 1))):
        assert not coef[:, 1:].any()
        luma_dc = coef[0, 0].item()
        assert (luma_dc == 0) == (value == 128)


def test_trellis_params_match_the_jax_tables():
    """Rate proxies from the standard AC tables: EOB 4 and ZRL 11 bits
    (luma), 2 and 10 (chroma); (0, 1) 2 bits for both."""
    luma, eob, zrl = jpeg_tables.ac_code_bits(False)
    assert (eob, zrl, luma[0, 1]) == (4, 11, 2)
    chroma, eob, zrl = jpeg_tables.ac_code_bits(True)
    assert (eob, zrl, chroma[0, 1]) == (2, 10, 2)
    block = jpeg_tables.trellis_param_block(90)
    assert block.dtype == np.float32 and block.size == jpeg_tables.TRELLIS_PARAM_WORDS


# ---------------------------------------------------------------------------
# the card's fixtures
# ---------------------------------------------------------------------------


def _fixture_dir():
    return tool.DEFAULT_OUT


def test_jpeg_encode_fixtures_are_the_jax_package_s():
    """tests/data/jpeg_enc is what tools/make_jpeg_encode_fixtures.py writes
    (which also checks the JAX handler's answers to its served URLs)."""
    reason = tool.missing()
    if reason:
        pytest.skip(f"the JAX package's native codec cannot be built here: {reason}")
    built = tool.build()
    assert sorted(os.listdir(_fixture_dir())) == sorted(built)
    for name, data in built.items():
        with open(os.path.join(_fixture_dir(), name), "rb") as fh:
            stored = fh.read()
        if name.endswith(".png"):
            np.testing.assert_array_equal(png.decode(stored)[0], png.decode(data)[0])
        elif name.endswith(".json"):
            assert json.loads(stored) == json.loads(data)
        else:
            assert stored == data, name


def test_port_encodes_are_the_fixtures():
    """Every file of tests/data/jpeg_enc from the port's encoder (the
    kernels' plain versions) of its source, as phase 10 encodes them on a
    card with the kernels."""
    with open(os.path.join(_fixture_dir(), "reference.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(_fixture_dir(), "source.png"), "rb") as fh:
        src, _ = png.decode(fh.read())
    for name, entry in ref["files"].items():
        with open(os.path.join(_fixture_dir(), name), "rb") as fh:
            want = fh.read()
        if entry["encoder"] == "fc_jpeg_encode_trellis":
            got = jpeg_enc.encode_trellis(src, entry["quality"], tuple(entry["sampling"]),
                                          device="cpu")
        elif entry["encoder"] == "fc_jpeg_encode":
            got = jpeg_enc.encode_plain(src, entry["quality"], sampling=tuple(entry["sampling"]),
                                        device="cpu")
        else:
            got = jpeg_enc.encode_cmyk(src, entry["quality"], entry["optimize"], device="cpu")
        assert got == want, name
        assert len(want) == entry["bytes"]


# ---------------------------------------------------------------------------
# the handler
# ---------------------------------------------------------------------------

HANDLER_OPTS = [
    "w_300,h_250,c_1,o_jpg", "w_300,h_250,c_1,o_jpg,moz_0", "o_jpg,sf_1x3", "o_jpg,sf_1x4",
    "o_jpg,sf_2x3", "o_jpg,sf_2x4", "o_jpg,sf_3x1", "o_jpg,sf_3x2", "o_jpg,sf_2x4,moz_0",
    "o_jpg,q_40,sf_4:2:0", "clsp_CMYK,o_jpg", "clsp_CMYK,o_jpg,moz_0,q_70", "st_0,o_jpg",
    "st_0,clsp_CMYK,o_jpg",
]


@pytest.fixture(scope="module")
def metadata_source(tmp_path_factory):
    """The fixtures' 300x250 source as a PNG with an ICC profile and EXIF
    (w_300,h_250,c_1 leaves its pixels as they are)."""
    from PIL import ImageCms

    with open(os.path.join(_fixture_dir(), "source.png"), "rb") as fh:
        src, _ = png.decode(fh.read())
    exif = Image.Exif()
    exif[0x010F] = "flyimg"
    exif[0x0112] = 1
    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    path = tmp_path_factory.mktemp("jpeg_enc_src") / "source.png"
    Image.fromarray(src).save(path, "PNG", icc_profile=icc, exif=exif)
    return str(path)


@pytest.mark.parametrize("opts", HANDLER_OPTS)
def test_handler_jpeg_answers_equal_the_jax_handler_s(fastcodec, metadata_source, tmp_path,
                                                      monkeypatch, opts):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    use_in_jax(monkeypatch, fastcodec)
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"), "tmp_dir": str(tmp_path / "jt")})
    want = JImageHandler(make_storage(jparams), jparams).process_image(opts, metadata_source)
    port = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                       "tmp_dir": str(tmp_path / "t")}), device="cpu")
    got = port.process_image(opts, metadata_source)
    assert got.spec.mime == want.spec.mime == "image/jpeg"
    assert got.spec.name == want.spec.name
    assert got.content == want.content
    assert (b"\xff\xee\x00\x0eAdobe" in got.content) == ("clsp_CMYK" in opts)
