"""The PyTorch package's lossy WebP (VP8) codec on the CPU, against the JAX
package's (libwebp's) and the fixtures tools/make_webp_fixtures.py writes.

- Decode: every fixture in tests/data/webp (libwebp's files: Pillow's
  qualities and methods, RGB and RGBA; the advanced API's simple filter,
  sharpness, segments, token partitions; ALPH of compression 0 and 1 with
  each filter) and a seeded matrix made here (1x1, 15x17, 61x87, 320x240;
  RGB and RGBA) decode to ``flyimg_tpu.codecs.decode``'s pixels. Bound:
  exact.
- Encode: the port's files (q 10/50/75/90/100, RGB and RGBA, 1x1 to
  1920x1080, and the bitstream options the C entry takes) decode in the
  JAX package to what the port's own decoder gives, exactly; alpha comes
  back exactly. On source.png and its w_300,h_250,c_1 answer, at q 50, 75
  and 90, the port's file has at most 1.3x the bytes and at least the PSNR
  less 0.75 dB of the JAX package's encode of the same pixels.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import flyimg_tpu.codecs as jcodecs
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import native_codec, png
from flyimg_tpu_torch.exceptions import ExecFailedException

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "webp")
FIXTURES = sorted(f[:-5] for f in os.listdir(DATA) if f.endswith(".webp")
                  and not f.startswith("jax_"))
BYTES_RATIO = 1.3
PSNR_LOSS_DB = 0.75


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (7 + 3 * c) + c) * np.cos(xx / (11 + c))
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def _alpha(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    a = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
    a[::3, ::2] = np.random.default_rng(seed).integers(0, 256, a[::3, ::2].shape)
    a.flat[0] = 17  # never all opaque, so the file carries alpha
    return a


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _assert_same_decode(got, want):
    assert got.size == want.size
    np.testing.assert_array_equal(got.rgb, want.rgb)
    if want.alpha is None:
        assert got.alpha is None
    else:
        np.testing.assert_array_equal(got.alpha, want.alpha)


def test_webp_fixtures_are_libwebp_s():
    """tests/data/webp is what tools/make_webp_fixtures.py writes: the same
    WebP files, the same decoded pixels, the same reference numbers."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_webp_fixtures", os.path.join(ROOT, "tools", "make_webp_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    built = tool.build()
    assert sorted(os.listdir(DATA)) == sorted(built)
    for name, data in built.items():
        stored = _read(name)
        if name.endswith(".png"):
            a, b = png.decode(stored), png.decode(data)
            np.testing.assert_array_equal(a[0], b[0])
            assert (a[1] is None) == (b[1] is None)
            if a[1] is not None:
                np.testing.assert_array_equal(a[1], b[1])
        else:
            assert stored == data, name


def test_fixtures_reach_every_decoder_path():
    """The fixtures cover both loop filters, sharpness, 1 and 4 segments,
    1 to 8 token partitions and ALPH of compression 0 and 1 with each
    filter (read from the files' own headers)."""
    seen = set()
    for name in FIXTURES:
        data = _read(name + ".webp")
        pos = 12
        while pos + 8 <= len(data):
            fourcc, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
            payload = data[pos + 8:pos + 8 + size]
            if fourcc == b"ALPH":
                seen.add(("alph", payload[0] & 3, (payload[0] >> 2) & 3))
            elif fourcc == b"VP8 ":
                seen.update(_frame_paths(payload))
            pos += 8 + size + (size & 1)
    for comp in (0, 1):
        for filt in range(4):
            assert ("alph", comp, filt) in seen
    for path in (("filter", "simple"), ("filter", "normal"), ("filter", "none"),
                 ("segments", 1), ("segments", 4), ("partitions", 1), ("partitions", 2),
                 ("partitions", 4), ("partitions", 8), ("sharpness", True)):
        assert path in seen, path


def _frame_paths(vp8):
    """The header features of a VP8 key frame (RFC 6386 section 9), read
    with a plain boolean decoder."""
    data, pos, value, rng, count = vp8[10:], 2, (vp8[10] << 8) | vp8[11], 255, 0

    def bit(prob=128):
        nonlocal pos, value, rng, count
        split = 1 + (((rng - 1) * prob) >> 8)
        if value >= split << 8:
            b, rng, value = 1, rng - split, value - (split << 8)
        else:
            b, rng = 0, split
        while rng < 128:
            value, rng, count = value << 1, rng << 1, count + 1
            if count == 8:
                count = 0
                value |= data[pos] if pos < len(data) else 0
                pos += 1
        return b

    def lit(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | bit()
        return v

    bit(), bit()
    paths = set()
    segments = bit()
    paths.add(("segments", 4 if segments else 1))
    if segments:
        update_map = bit()
        if bit():
            bit()
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if bit():
                    lit(n), bit()
        if update_map:
            for _ in range(3):
                if bit():
                    lit(8)
    simple, level, sharpness = bit(), lit(6), lit(3)
    paths.add(("filter", "none" if level == 0 else "simple" if simple else "normal"))
    paths.add(("sharpness", sharpness > 0))
    if bit() and bit():
        for _ in range(8):
            if bit():
                lit(6), bit()
    paths.add(("partitions", 1 << lit(2)))
    return paths


@pytest.mark.parametrize("name", FIXTURES)
def test_decode_of_fixture_matches_jax(name):
    data = _read(name + ".webp")
    got = codecs.decode(data)
    _assert_same_decode(got, jcodecs.decode(data))
    rgb, alpha = png.decode(_read(name + ".png"))
    np.testing.assert_array_equal(got.rgb, rgb)
    if alpha is not None:
        np.testing.assert_array_equal(got.alpha, alpha)


@pytest.mark.parametrize("shape", [(1, 1), (15, 17), (61, 87), (240, 320)])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("quality,method", [(20, 2), (95, 5)])
def test_decode_of_seeded_matrix_matches_jax(shape, mode, quality, method):
    img = _photo(*shape, seed=shape[1])
    if mode == "RGBA":
        img = np.dstack([img, _alpha(*shape)])
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "WEBP", quality=quality, method=method)
    _assert_same_decode(codecs.decode(buf.getvalue()), jcodecs.decode(buf.getvalue()))


@pytest.mark.parametrize("shape", [(1, 1), (15, 17), (61, 87), (250, 300)])
@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("quality", [10, 50, 75, 90, 100])
def test_port_encode_decodes_alike_in_jax(shape, with_alpha, quality):
    """A lossy file of the port: a valid WebP (the JAX package decodes it)
    whose pixels the port's decoder gives exactly, alpha exact."""
    img = _photo(*shape, seed=quality)
    alpha = _alpha(*shape, seed=quality) if with_alpha else None
    data = codecs.encode(img, "webp", alpha, quality=quality)
    assert data[12:16] == (b"VP8X" if with_alpha else b"VP8 ")
    want = jcodecs.decode(data)
    _assert_same_decode(codecs.decode(data), want)
    if with_alpha:
        np.testing.assert_array_equal(want.alpha, alpha)
    assert _psnr(want.rgb, img) > 20.0


def test_port_encode_of_a_full_hd_frame_decodes_alike_in_jax():
    img = _photo(1080, 1920, seed=3)
    data = codecs.encode(img, "webp", quality=75)
    _assert_same_decode(codecs.decode(data), jcodecs.decode(data))


@pytest.mark.parametrize("options", [
    dict(simple_filter=True), dict(sharpness=5), dict(simple_filter=True, sharpness=7),
    dict(partitions_log2=1), dict(partitions_log2=3), dict(mode_lf_delta=12),
    dict(mode_lf_delta=-20, sharpness=2),
])
def test_port_encode_options_decode_alike_in_jax(options):
    """The bitstream options the C entry takes (the simple filter,
    sharpness, token partitions, the loop-filter delta of sub-block
    macroblocks, which no libwebp file here carries) decode alike."""
    img = _photo(61, 87, seed=9)
    alpha = _alpha(61, 87)
    data = native_codec.webp_encode(np.dstack([img, alpha]), 40, **options)
    _assert_same_decode(codecs.decode(data), jcodecs.decode(data))
    assert ("filter", "simple" if options.get("simple_filter") else "normal") in \
        _frame_paths(data[data.index(b"VP8 ") + 8:])


@pytest.mark.parametrize("tag", ["source", "answer"])
@pytest.mark.parametrize("quality", [50, 75, 90])
def test_encode_bytes_and_psnr_against_jax(tag, quality):
    """The port's encode of source.png and of its w_300,h_250,c_1 answer
    against the JAX package's encode of the same pixels (made here and kept
    in reference.json): at most BYTES_RATIO the bytes, at least the PSNR
    less PSNR_LOSS_DB."""
    with open(os.path.join(DATA, "reference.json")) as fh:
        ref = json.load(fh)
    path = os.path.join(DATA, ref["sources"][tag])
    with open(path, "rb") as fh:
        px, _ = png.decode(fh.read())
    jax = jcodecs.encode(px, "webp", quality=quality, webp_lossless=False)
    assert len(jax) == ref["encodes"][f"{tag}_q{quality}"]["bytes"]
    jax_psnr = _psnr(jcodecs.decode(jax).rgb, px)
    data = codecs.encode(px, "webp", quality=quality)
    got = _psnr(jcodecs.decode(data).rgb, px)
    assert len(data) <= BYTES_RATIO * len(jax), (len(data), len(jax))
    assert got >= jax_psnr - PSNR_LOSS_DB, (got, jax_psnr)


def test_quality_map_is_monotone():
    """The encoder's quality -> quantizer index map (webp_lossy.cpp
    quality_to_qindex): 0 -> 114, 100 -> 0, never larger for a higher
    quality."""
    lib = native_codec._webp()
    index = [lib.fl_webp_qindex(q) for q in range(101)]
    assert index[0] == 114 and index[100] == 0
    assert all(a >= b for a, b in zip(index, index[1:]))
    assert [index[q] for q in (50, 75, 90)] == [35, 23, 8]


@pytest.mark.parametrize("quality,method", [(30, 0), (90, 4), (100, 6)])
def test_cut_files_fail_as_jax_s(quality, method):
    """A VP8 frame cut short (the RIFF sizes kept consistent) fails where
    the JAX package's decode fails and decodes to its pixels where it
    decodes, for every cut but those in the last three bytes (where
    libwebp may refuse a frame the port reads; webp_lossy.cpp
    BoolDecoder)."""
    from tools.make_webp_fixtures import chunks, riff

    buf = io.BytesIO()
    Image.fromarray(_photo(64, 80, seed=quality)).save(buf, "WEBP", quality=quality,
                                                        method=method)
    vp8 = dict(chunks(buf.getvalue()))[b"VP8 "]
    for cut in sorted(set(range(1, len(vp8) - 3, max(1, len(vp8) // 50))) | {len(vp8) - 4}):
        data = riff([(b"VP8 ", vp8[:cut])])
        try:
            want = jcodecs.decode(data)
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ExecFailedException, match="WebP decode failed: [a-zA-Z]"):
                codecs.decode(data)
        else:
            _assert_same_decode(codecs.decode(data), want)


def test_animated_webp_is_refused():
    """An animated WebP was refused until the port composited animations
    (codecs/webp_anim.py): it now decodes to its first frame as the JAX
    package's Pillow path does, through codecs.decode and through
    native_codec.webp_decode_auto alike."""
    frames = [Image.fromarray(_photo(16, 16, seed=k)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    got = codecs.decode(buf.getvalue())
    _assert_same_decode(got, jcodecs.decode(buf.getvalue()))
    assert got.n_frames == 2
    pixels, channels = native_codec.webp_decode_auto(buf.getvalue())
    assert channels == 3
    np.testing.assert_array_equal(pixels, got.rgb)
