"""The port's GIF codec (``flyimg_tpu_torch/codecs/gif.py``) and the
handler's animation branch, held against the JAX package on the CPU.

Decode: every frame equals the JAX package's (``pil_codec.decode`` with
``frame``, the handler's ``_decode_all_frames``: Pillow 12's composited
RGBA), on Pillow-written files and on hand-built ones with disposal 0-3,
partial frames, local colour tables, interlace, transparent indices, gray
files and no NETSCAPE block. Encode: the frame count, durations, loop and
transparent index of the JAX package's files of the same pixels, a PSNR at
least theirs less 0.75 dB and at most 1.3x their bytes (the palette and the
bytes come out equal to Pillow's, and that is pinned too). Handler: the
port's ``ImageHandler(device="cpu")`` against the JAX ``ImageHandler``;
one animation's frames share one launch. Inputs come from numpy with fixed
seeds.
"""

import io
import json
import os

import format_writers as fb
import numpy as np
import pytest
from PIL import Image, ImageSequence

from flyimg_tpu.codecs import pil_codec
from flyimg_tpu.service.handler import _decode_all_frames, _encode_gif_animation
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import gif, png, rasterlib
from flyimg_tpu_torch.exceptions import UnsupportedMediaException

DATA = os.path.join(os.path.dirname(__file__), "data", "gif")
PSNR_LOSS_DB = 0.75
BYTES_RATIO = 1.3
HANDLER_PSNR_DB = 30.0


def photo(h, w, seed, shift=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // max(w - 1, 1) + shift) % 256, y * 255 // max(h - 1, 1),
                    ((x + y) * 127 // max(w + h - 2, 1) + 2 * shift) % 256], -1)
    return np.clip(img + rng.integers(-12, 13, size=img.shape), 0, 255).astype(np.uint8)


def psnr(a, b, mask=None):
    diff = (a.astype(np.float64) - b.astype(np.float64)) ** 2
    if mask is not None:
        diff = diff[mask]
    mse = float(diff.mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def assert_same_decode(data):
    """Every frame as the JAX package decodes it, both ways."""
    want = _decode_all_frames(data)
    got = gif.decode_all(data)
    assert got.durations == want.durations and got.loop == want.loop
    assert len(got.frames) == len(want.frames)
    assert (got.alphas is None) == (want.alphas is None)
    for i, frame in enumerate(want.frames):
        np.testing.assert_array_equal(got.frames[i], frame, err_msg=f"frame {i}")
        if want.alphas is not None:
            np.testing.assert_array_equal(got.alphas[i], want.alphas[i], err_msg=f"alpha {i}")
    for f in range(len(want.frames) + 1):
        ref = pil_codec.decode(data, frame=f)
        dec = codecs.decode(data, frame=f, device="cpu")
        assert dec.n_frames == ref.n_frames and dec.mime == "image/gif"
        np.testing.assert_array_equal(dec.rgb, ref.rgb, err_msg=f"gf_{f}")
        assert (dec.alpha is None) == (ref.alpha is None), f"gf_{f}"
        if ref.alpha is not None:
            np.testing.assert_array_equal(dec.alpha, ref.alpha, err_msg=f"gf_{f} alpha")


def pil_animation(frames, **kw):
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("kw", [
    dict(duration=[30, 40, 50, 60], loop=0),
    dict(duration=70),
    dict(duration=[10, 20, 30, 40], loop=5, disposal=2),
    dict(duration=[10, 20, 30, 40], disposal=[0, 1, 2, 3]),
])
def test_pillow_animations_decode_as_the_jax_package(kw):
    frames = [photo(36, 52, k, 30 * k) for k in range(4)]
    frames[2] = frames[1].copy()
    assert_same_decode(pil_animation(frames, **kw))


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
def test_pillow_stills_decode_as_the_jax_package(mode):
    buf = io.BytesIO()
    Image.fromarray(photo(30, 44, 3)).convert(mode).save(buf, "GIF")
    assert_same_decode(buf.getvalue())


def test_pillow_transparent_animation_decodes_as_the_jax_package():
    y, x = np.mgrid[0:40, 0:48]
    frames = []
    for k in range(3):
        a = np.where((x + 8 * k) % 24 < 12, 255, 0).astype(np.uint8)
        frames.append(Image.fromarray(np.dstack([photo(40, 48, 9 + k), a])))
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=60,
                   disposal=2)
    assert_same_decode(buf.getvalue())


_RNG = np.random.default_rng(18)
_GPAL = _RNG.integers(0, 256, size=(16, 3)).astype(np.uint8)
_LPAL = _RNG.integers(0, 256, size=(8, 3)).astype(np.uint8)


def _hand(first_t, disposal, trans):
    rng = np.random.default_rng(100 * (first_t or 0) + 10 * disposal + (trans or 0))

    def blk(h, w, n):
        return rng.integers(0, n, size=(h, w))

    frames = [
        dict(idx=blk(30, 40, 16), transparency=first_t, disposal=disposal),
        dict(idx=blk(12, 17, 16), offset=(5, 7), disposal=disposal, transparency=trans,
             interlace=True),
        dict(idx=blk(10, 9, 8), offset=(20, 11), local=_LPAL, transparency=trans),
        dict(idx=blk(14, 20, 16), offset=(3, 2), disposal=(disposal + 1) % 4,
             gce=disposal != 1, transparency=trans),
        dict(idx=blk(8, 8, 16), offset=(30, 20), code_size=5),
    ]
    return fb.gif((40, 30), frames, _GPAL, background=4,
                  loop=None if disposal % 2 else 2)


@pytest.mark.parametrize("first_t", [None, 3])
@pytest.mark.parametrize("disposal", [0, 1, 2, 3])
@pytest.mark.parametrize("trans", [None, 5])
def test_hand_built_frames_decode_as_the_jax_package(first_t, disposal, trans):
    """Disposal 0-3 (kept from a frame without one), partial frames, a local
    table, interlace, transparent indices, and no NETSCAPE block."""
    assert_same_decode(_hand(first_t, disposal, trans))


@pytest.mark.parametrize("case", ["gray", "ramp_table", "partial_first", "past_table",
                                  "no_gce", "background"])
def test_hand_built_layouts_decode_as_the_jax_package(case):
    rng = np.random.default_rng(7)

    def blk(h, w, n):
        return rng.integers(0, n, size=(h, w))

    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    gray = [dict(idx=blk(30, 40, 200), transparency=7),
            dict(idx=blk(10, 10, 200), offset=(4, 4), transparency=9, disposal=2),
            dict(idx=blk(10, 10, 200), offset=(14, 4))]
    data = {
        "gray": lambda: fb.gif((40, 30), gray, None),
        "ramp_table": lambda: fb.gif((40, 30), gray, ramp),
        "partial_first": lambda: fb.gif((40, 30), [
            dict(idx=blk(10, 10, 16), offset=(3, 3), gce=False),
            dict(idx=blk(10, 10, 16), offset=(13, 13), disposal=3),
            dict(idx=blk(5, 5, 16), transparency=2)], _GPAL, background=9),
        "past_table": lambda: fb.gif((40, 30), [
            dict(idx=blk(30, 40, 40)), dict(idx=blk(10, 10, 40), offset=(1, 1), local=_LPAL)],
            _GPAL[:4]),
        "no_gce": lambda: fb.gif((40, 30), [dict(idx=blk(30, 40, 16), gce=False),
                                            dict(idx=blk(9, 9, 16), gce=False)], _GPAL),
        "background": lambda: fb.gif((40, 30), [
            dict(idx=blk(30, 40, 16), disposal=2),
            dict(idx=blk(9, 9, 16), offset=(6, 6), disposal=2),
            dict(idx=blk(9, 9, 16), offset=(20, 6))], _GPAL, background=11),
    }[case]()
    assert_same_decode(data)


def test_gif_coalesce_respects_disposal_and_transparency():
    """tests/test_handler.py:810's case through the port."""
    ims = []
    for arr in (np.zeros((48, 64), np.uint8),
                np.where(np.pad(np.ones((20, 30), bool), ((5, 23), (5, 29))), 1, 255),
                np.full((48, 64), 2, np.uint8)):
        im = Image.fromarray(arr.astype(np.uint8), "P")
        im.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255] + [0] * (253 * 3))
        ims.append(im)
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], duration=[30, 50, 70],
                disposal=2, transparency=255, optimize=False)
    anim = gif.decode_all(buf.getvalue())
    assert len(anim.frames) == 3 and anim.durations == [30, 50, 70]
    assert anim.loop is None and anim.alphas is not None
    assert tuple(anim.frames[0][24, 32]) == (255, 0, 0) and anim.alphas[0].min() == 255
    assert tuple(anim.frames[1][15, 20]) == (0, 255, 0) and anim.alphas[1][15, 20] == 255
    assert anim.alphas[1][40, 50] == 0
    assert tuple(anim.frames[2][24, 32]) == (0, 0, 255)
    assert_same_decode(buf.getvalue())


def test_frame_outside_the_screen_is_refused_by_name():
    """A frame past the logical screen is not refused: the screen widens to
    25x25 as Pillow widens it, and every frame equals the JAX package's."""
    data = fb.gif((20, 20), [dict(idx=np.zeros((20, 20))),
                             dict(idx=np.zeros((10, 10)), offset=(15, 15))], _GPAL)
    assert _decode_all_frames(data).frames[1].shape == (25, 25, 3)
    assert gif.decode_all(data).frames[1].shape == (25, 25, 3)
    assert_same_decode(data)


_WIDEN_LOCAL = np.array([[5, 6, 7], [100, 100, 0], [0, 90, 90], [9, 9, 9]], np.uint8)
_WIDEN = {
    "plain": [dict(), dict(offset=(15, 15))],
    "transparent": [dict(), dict(offset=(15, 15), transparency=2)],
    "first_transparent": [dict(transparency=1), dict(offset=(15, 15))],
    "both_transparent": [dict(transparency=1), dict(offset=(15, 15), transparency=3)],
    "first_frame": [dict(offset=(5, 5)), dict()],
    "first_frame_transparent": [dict(offset=(5, 5), transparency=0), dict()],
    "local_table": [dict(), dict(offset=(15, 15), local=_WIDEN_LOCAL)],
    "disposal_2": [dict(), dict(offset=(15, 15), disposal=2), dict(offset=(3, 3))],
    "disposal_3": [dict(), dict(offset=(15, 15), disposal=3), dict(offset=(22, 22))],
    "disposal_3_then_alpha": [dict(), dict(offset=(2, 2), disposal=3),
                              dict(offset=(15, 15), transparency=1, disposal=3),
                              dict(offset=(1, 1))],
    "twice": [dict(), dict(offset=(15, 15), transparency=1), dict(offset=(28, 2))],
    "first_disposal_3": [dict(offset=(4, 4), disposal=3, transparency=2),
                         dict(offset=(15, 15))],
}


@pytest.mark.parametrize("gray", [False, True], ids=["palette", "gray"])
@pytest.mark.parametrize("case", sorted(_WIDEN))
def test_frame_outside_the_screen_widens_it_as_pillow(case, gray):
    """Frames past the 20x20 screen, with and without transparent indices,
    disposals and local tables, in a palette or a gray file: every frame and
    every ``gf_`` decode equals the JAX package's."""
    rng = np.random.default_rng(len(case))
    frames = []
    for k, spec in enumerate(_WIDEN[case]):
        side = 20 if k == 0 else (10 if k == 1 else 5 + k)
        frame = dict(spec, idx=rng.integers(0, 4, (side, side)))
        if gray:
            frame.pop("local", None)
        frames.append(frame)
    assert_same_decode(fb.gif((20, 20), frames, None if gray else _GPAL))


@pytest.mark.parametrize("name", sorted(
    f[:-4] for f in os.listdir(DATA) if f.endswith(".gif") and not f.startswith("jax_")))
def test_fixtures_equal_their_pngs(name):
    """Every committed fixture decodes to its PNGs (which the card's
    phase 13 reads with the port's PNG decoder) and to Pillow's frames."""
    with open(os.path.join(DATA, name + ".gif"), "rb") as fh:
        data = fh.read()
    ref = json.load(open(os.path.join(DATA, "reference.json")))["decode"][name]
    anim = gif.decode_all(data)
    assert len(anim.frames) == ref["frames"] and anim.durations == ref["durations"]
    assert anim.loop == ref["loop"]
    for i, frame in enumerate(anim.frames):
        with open(os.path.join(DATA, f"{name}.f{i}.png"), "rb") as fh:
            rgb, alpha = png.decode(fh.read())
        np.testing.assert_array_equal(frame, rgb)
        if anim.alphas is not None:
            np.testing.assert_array_equal(anim.alphas[i], alpha)
    assert_same_decode(data)


# ------------------------------------------------------------------ encode


def _gce_transparency(data):
    """Each image's GCE transparent index (None without one), from the
    bytes, and the image count."""
    out, pending, pos = [], None, 13
    if data[10] & 128:
        pos += 3 << ((data[10] & 7) + 1)
    while pos < len(data) and data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                pending = data[pos + 6] if data[pos + 3] & 1 else None
            pos += 2
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
        elif data[pos] == 0x2C:
            flags = data[pos + 9]
            pos += 10
            if flags & 128:
                pos += 3 << ((flags & 7) + 1)
            pos += 1
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
            out.append(pending)
            pending = None
        else:
            pos += 1
    return out


def _encode_case(kind):
    frames = [photo(40, 56, 20 + k, 20 * k) for k in range(5)]
    frames.insert(2, frames[1].copy())
    y, x = np.mgrid[0:40, 0:56]
    alphas = [np.where((x + 7 * k) % 28 < 16, 255, 0).astype(np.uint8)
              for k in range(len(frames))]
    alphas[3] = ((x * 5 + y) % 256).astype(np.uint8)
    durations = [40, 60, 80, 100, 120, 140]
    if kind == "still":
        return frames[:1], None, None, None
    if kind == "opaque":
        return frames, None, durations, 0
    if kind == "opaque_play_once":
        return frames[:3], None, durations[:3], None
    if kind == "transparent":
        return frames, alphas, durations, None
    if kind == "transparent_loop":
        return frames, [np.full_like(alphas[0], 255)] + alphas[1:], durations, 3
    if kind == "few_colours":
        few = [(f // 64 * 64).astype(np.uint8) for f in frames]
        return few, None, durations, 0
    raise ValueError(kind)


def _jax_encode(frames, alphas, durations, loop):
    if durations is None:
        return pil_codec.encode(frames[0], "gif")
    return _encode_gif_animation(frames, alphas, durations, loop)


def _port_encode(frames, alphas, durations, loop):
    if durations is None:
        return codecs.encode(frames[0], "gif", device="cpu")
    return codecs.encode_animation(frames, alphas, durations, loop)


def _frame_scores(blob, frames, alphas):
    anim = _decode_all_frames(blob)
    kept = [0] + [i for i in range(1, len(frames)) if not (
        np.array_equal(frames[i], frames[i - 1])
        and (alphas is None or np.array_equal(alphas[i] >= 128, alphas[i - 1] >= 128)))]
    return [psnr(anim.frames[k], frames[i], None if alphas is None else alphas[i] >= 128)
            for k, i in enumerate(kept[: len(anim.frames)])]


ENCODE_CASES = ["still", "opaque", "opaque_play_once", "transparent", "transparent_loop",
                "few_colours"]


@pytest.mark.parametrize("kind", ENCODE_CASES)
def test_encoder_meets_the_jax_bars(kind):
    """Frame count, durations, loop and transparent indices as the JAX
    package's file of the same pixels; per-frame PSNR within 0.75 dB of
    it, at no more than 1.3x its bytes."""
    frames, alphas, durations, loop = _encode_case(kind)
    want = _jax_encode(frames, alphas, durations, loop)
    got = _port_encode(frames, alphas, durations, loop)
    wi, gi = (Image.open(io.BytesIO(b)) for b in (want, got))
    assert gi.format == "GIF" and gi.n_frames == wi.n_frames
    assert gi.info.get("loop") == wi.info.get("loop")
    wa, ga = _decode_all_frames(want), _decode_all_frames(got)
    assert ga.durations == wa.durations and ga.loop == wa.loop
    assert _gce_transparency(got) == _gce_transparency(want)
    assert len(got) <= BYTES_RATIO * len(want)
    for g, w in zip(_frame_scores(got, frames, alphas), _frame_scores(want, frames, alphas)):
        assert g >= w - PSNR_LOSS_DB
    if alphas is not None:
        for k in range(len(ga.frames)):
            np.testing.assert_array_equal(ga.alphas[k], wa.alphas[k])


@pytest.mark.parametrize("kind", ENCODE_CASES)
def test_encoder_writes_pillows_palette_and_bytes(kind):
    """The median cut follows Pillow's Quant.c and the writer its GIF
    plugin: on these inputs the palette and the file come out equal."""
    frames, alphas, durations, loop = _encode_case(kind)
    assert _port_encode(frames, alphas, durations, loop) == \
        _jax_encode(frames, alphas, durations, loop)


@pytest.mark.parametrize("case", ["few", "noise", "gradient", "scaled"])
def test_quantizer_equals_pillows_median_cut(case):
    rng = np.random.default_rng(4)
    img = {
        "few": lambda: rng.integers(0, 5, size=(40, 50, 3)).astype(np.uint8) * 60,
        "noise": lambda: rng.integers(0, 256, size=(60, 80, 3)).astype(np.uint8),
        "gradient": lambda: photo(120, 160, 3),
        # more than 65536 colours: the histogram drops bits, as Quant.c does
        "scaled": lambda: np.clip(photo(300, 400, 4).astype(int)
                                  + rng.integers(-40, 41, size=(300, 400, 3)),
                                  0, 255).astype(np.uint8),
    }[case]()
    palette, idx = rasterlib.quantize(img, 256)
    p = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE)
    np.testing.assert_array_equal(palette, np.asarray(p.getpalette()).reshape(-1, 3))
    np.testing.assert_array_equal(idx, np.asarray(p))


@pytest.mark.parametrize("name", ["jax_still", "jax_anim", "jax_anim_alpha"])
def test_committed_jax_encodes_hold_the_bars(name):
    """The card's phase 13 holds the port's encodes of enc.f*.png against
    the committed JAX files' numbers in reference.json: the same check here."""
    ref = json.load(open(os.path.join(DATA, "reference.json")))
    entry = ref["encode"][name + ".gif"]
    frames, alphas = [], []
    for i in range(ref["encode_inputs"]["frames"]):
        with open(os.path.join(DATA, f"enc.f{i}.png"), "rb") as fh:
            rgb, alpha = png.decode(fh.read())
        frames.append(rgb)
        alphas.append(alpha)
    alphas = alphas if entry["alpha"] else None
    if name == "jax_still":
        blob = codecs.encode(frames[0], "gif", device="cpu")
    else:
        blob = codecs.encode_animation(frames, alphas, ref["encode_inputs"]["durations"],
                                       entry["loop"])
    with open(os.path.join(DATA, name + ".gif"), "rb") as fh:
        assert len(fh.read()) == entry["bytes"]
    anim = gif.decode_all(blob)
    assert len(anim.frames) == entry["frames"] and anim.durations == entry["durations"]
    assert anim.loop == entry["loop"]
    assert len(blob) <= BYTES_RATIO * entry["bytes"]
    for k, i in enumerate(entry["source_frames"]):
        mask = None if alphas is None else alphas[i] >= 128
        assert psnr(anim.frames[k], frames[i], mask) >= entry["psnr"][k] - PSNR_LOSS_DB


# ------------------------------------------------------------------ handler


@pytest.fixture(scope="module")
def handlers(tmp_path_factory):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.handler import ImageHandler

    root = tmp_path_factory.mktemp("torch_gif")
    params = AppParameters({"upload_dir": str(root / "u"), "tmp_dir": str(root / "t")})
    batcher = BatchController(max_batch=32, deadline_ms=20.0, device="cpu")
    handler = ImageHandler(params, device="cpu", batcher=batcher)
    jparams = JAppParameters({"upload_dir": str(root / "ju"), "tmp_dir": str(root / "jt")})
    jhandler = JImageHandler(make_storage(jparams), jparams)
    y, x = np.mgrid[0:60, 0:80]
    opaque = root / "opaque.gif"
    opaque.write_bytes(pil_animation([photo(60, 80, 40 + k, 25 * k) for k in range(5)],
                                     duration=[40, 50, 60, 70, 80], loop=0))
    alpha = root / "transparent.gif"
    ims = []
    for k in range(4):
        a = np.where(((x + 9 * k) % 40 < 24) | (y < 8), 255, 0).astype(np.uint8)
        ims.append(Image.fromarray(np.dstack([photo(60, 80, 50 + k, 20 * k), a])))
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], duration=[30, 50, 70, 90],
                disposal=2)
    alpha.write_bytes(buf.getvalue())
    still = root / "still.gif"
    buf = io.BytesIO()
    Image.fromarray(photo(60, 80, 60)).save(buf, "GIF")
    still.write_bytes(buf.getvalue())
    webp = root / "anim.webp"
    buf = io.BytesIO()
    wims = [Image.fromarray(np.dstack([photo(60, 80, 70 + k, 30 * k),
                                       np.where((x + 10 * k) % 30 < 20, 255, 90)
                                       .astype(np.uint8)])) for k in range(4)]
    wims[0].save(buf, "WEBP", save_all=True, append_images=wims[1:], duration=45, loop=2,
                 lossless=True)
    webp.write_bytes(buf.getvalue())
    srcs = {"opaque": str(opaque), "transparent": str(alpha), "still": str(still),
            "webp": str(webp)}
    yield handler, jhandler, srcs
    batcher.close()


def _frames_of(content):
    im = Image.open(io.BytesIO(content))
    frames = [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(im)]
    durations = [f.info.get("duration") for f in ImageSequence.Iterator(Image.open(
        io.BytesIO(content)))]
    return im, frames, durations


@pytest.mark.parametrize("opts,src", [
    ("w_40,o_gif", "opaque"),
    ("w_32,o_gif", "transparent"),
    ("w_300,h_250,c_1,smc_1,o_gif", "opaque"),
    ("w_64,r_30,blr_1,o_gif", "transparent"),
    ("w_50,clsp_Gray,o_gif", "opaque"),
    ("w_40,o_gif", "webp"),
    ("w_40,o_gif", "still"),
    ("o_auto", "opaque"),
    ("w_45,o_gif,gf_2", "opaque"),
])
def test_gif_answers_match_the_jax_handler(handlers, opts, src):
    """Type, size, frame count, durations and loop as the JAX handler;
    transparency masks equal except where the JAX alpha is within 1 level
    of 128; per-frame PSNR at least 30 dB."""
    handler, jhandler, srcs = handlers
    got = handler.process_image(opts, srcs[src])
    want = jhandler.process_image(opts, srcs[src])
    assert got.spec.mime == want.spec.mime == "image/gif"
    gi, gf, gd = _frames_of(got.content)
    wi, wf, wd = _frames_of(want.content)
    assert gi.size == wi.size and len(gf) == len(wf)
    assert gd == wd and gi.info.get("loop") == wi.info.get("loop")
    for k, (g, w) in enumerate(zip(gf, wf)):
        assert psnr(g[..., :3], w[..., :3], w[..., 3] > 0) >= HANDLER_PSNR_DB, f"frame {k}"
        np.testing.assert_array_equal(g[..., 3] == 0, w[..., 3] == 0, err_msg=f"frame {k}")


@pytest.mark.parametrize("opts,src,accept", [
    ("o_png,gf_2", "opaque", False),
    ("o_png,gf_3", "webp", False),
    ("w_30,o_auto", "webp", False),
    ("w_30,o_auto", "opaque", True),
])
def test_still_answers_of_animated_sources_match_the_jax_handler(handlers, opts, src, accept):
    """A still answer renders frame gf_ (PNG, or o_auto's WebP to a client
    that accepts it, and GIF by source MIME otherwise)."""
    handler, jhandler, srcs = handlers
    got = handler.process_image(opts, srcs[src], accepts_webp=accept)
    want = jhandler.process_image(opts, srcs[src], accepts_webp=accept)
    assert got.spec.mime == want.spec.mime
    g = np.asarray(Image.open(io.BytesIO(got.content)).convert("RGBA"))
    w = np.asarray(Image.open(io.BytesIO(want.content)).convert("RGBA"))
    assert g.shape == w.shape
    assert psnr(g[..., :3], w[..., :3]) >= HANDLER_PSNR_DB
    assert np.abs(g[..., 3].astype(int) - w[..., 3]).max() <= 1


def test_transparent_play_once_keeps_masks_durations_and_no_loop(handlers):
    """tests/test_handler.py:837's case through the port: a transparent,
    play-once GIF at w_32 keeps its holes, its durations and no loop."""
    handler, jhandler, srcs = handlers
    src = srcs["transparent"]
    got = handler.process_image("w_32,o_gif", src)
    want = jhandler.process_image("w_32,o_gif", src)
    out = Image.open(io.BytesIO(got.content))
    assert out.n_frames == 4 and "loop" not in out.info
    _gi, gf, gd = _frames_of(got.content)
    _wi, wf, _wd = _frames_of(want.content)
    assert gd == [30, 50, 70, 90]
    # the JAX alpha before its threshold: masks agree except within 1 level
    # of 128 there
    anim = _decode_all_frames(open(src, "rb").read())
    for g, w in zip(gf, wf):
        np.testing.assert_array_equal(g[..., 3] == 0, w[..., 3] == 0)
    assert anim.alphas is not None


def test_gif_answer_carries_no_metadata_and_identifies_as_gif(handlers):
    handler, _jhandler, srcs = handlers
    got = handler.process_image("w_40,o_gif,st_0,rf_1", srcs["opaque"])
    assert got.content[:6] == b"GIF89a" and got.spec.identify_repr.split()[1] == "GIF"


def test_cmyk_gif_is_refused_before_decode(handlers, monkeypatch):
    from flyimg_tpu_torch.exceptions import InvalidArgumentException

    handler, _jhandler, srcs = handlers
    monkeypatch.setattr(codecs, "decode", lambda *a, **k: pytest.fail("decoded"))
    with pytest.raises(InvalidArgumentException, match="clsp_CMYK"):
        handler.process_image("w_40,clsp_CMYK,o_gif", srcs["opaque"])


def test_animated_gif_frames_share_one_batch(tmp_path):
    """tests/test_handler.py:515 through the port: all frames are submitted
    before any wait, so with max_batch=8 and no lone flush the four frames
    of an animation run as one launch."""
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.handler import ImageHandler

    params = AppParameters({"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t")})
    frames = [np.full((60, 80, 3), c, np.uint8) for c in (30, 90, 150, 210)]
    src = tmp_path / "batchanim.gif"
    src.write_bytes(pil_animation(frames, duration=80, loop=0))
    batcher = BatchController(max_batch=8, deadline_ms=40.0, lone_flush=False, device="cpu")
    try:
        handler = ImageHandler(params, device="cpu", batcher=batcher)
        result = handler.process_image("w_40,o_gif", str(src))
        out = Image.open(io.BytesIO(result.content))
        assert out.format == "GIF" and out.n_frames == 4
        assert list(batcher.launch_log) == [("transform", 4, 4)]
    finally:
        batcher.close()


def test_transparent_animation_runs_colour_and_alpha_frames_in_one_batch(tmp_path):
    """A transparent animation's alpha planes ride as extra frames under a
    geometry-only plan: a different program, so colour and alpha each take
    one launch of their frames."""
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.handler import ImageHandler

    params = AppParameters({"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t")})
    y, x = np.mgrid[0:48, 0:64]
    ims = [Image.fromarray(np.dstack([photo(48, 64, k), np.where((x + 5 * k) % 20 < 12, 255, 0)
                                      .astype(np.uint8)])) for k in range(3)]
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], duration=50, disposal=2)
    src = tmp_path / "alpha.gif"
    src.write_bytes(buf.getvalue())
    batcher = BatchController(max_batch=8, deadline_ms=40.0, lone_flush=False, device="cpu")
    try:
        handler = ImageHandler(params, device="cpu", batcher=batcher)
        handler.process_image("w_32,clsp_Gray,o_gif", str(src))
        assert [(kind, members) for kind, members, _padded in batcher.launch_log] == \
            [("transform", 3), ("transform", 3)]
    finally:
        batcher.close()
