"""Write the fixtures of the port's raster codecs: ``tests/data/gif/``,
``tests/data/webp_anim/`` and ``tests/data/raster/``.

Each source file comes with PNGs of the JAX package's decode of it (its
Pillow path): ``<name>.png`` for a still, ``<name>.f<i>.png`` for every frame
of an animation, ``<name>.p<i>.png`` for every page of a TIFF; RGBA where
the decode has alpha. ``tests/data/gif/`` also holds the JAX package's GIF
encodes (``jax_*.gif``) of seeded frames (``enc_*.png``) with their sizes and
per-frame PSNR in ``reference.json``, the bars the port's GIF encoder is held
to. Every input is made from numpy with a fixed seed, so the files are
reproducible with the same Pillow (12.1 made the committed ones).

Run from the repo root on a host with Pillow and the JAX package:

    JAX_PLATFORMS=cpu python tools/make_format_fixtures.py
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import format_writers as fb  # noqa: E402
from flyimg_tpu.codecs import pil_codec  # noqa: E402
from flyimg_tpu.service.handler import (  # noqa: E402
    _decode_all_frames,
    _encode_gif_animation,
)

DATA = os.path.join(ROOT, "tests", "data")


def photo(h: int, w: int, seed: int, shift: int = 0) -> np.ndarray:
    """Smooth gradients with seeded noise: a frame with many colours."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // max(w - 1, 1) + shift) % 256, y * 255 // max(h - 1, 1),
                    ((x + y) * 127 // max(w + h - 2, 1) + 2 * shift) % 256], -1)
    return np.clip(img + rng.integers(-5, 6, size=img.shape), 0, 255).astype(np.uint8)


def png_bytes(rgb: np.ndarray, alpha=None) -> bytes:
    buf = io.BytesIO()
    px = rgb if alpha is None else np.dstack([rgb, alpha])
    Image.fromarray(px).save(buf, "PNG")
    return buf.getvalue()


def write(folder: str, name: str, data: bytes) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, name), "wb") as fh:
        fh.write(data)


def psnr(a: np.ndarray, b: np.ndarray, mask=None) -> float:
    diff = (a.astype(np.float64) - b.astype(np.float64)) ** 2
    if mask is not None:
        diff = diff[mask]
    mse = float(diff.mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def animation_fixture(folder: str, name: str, data: bytes, ref: dict) -> None:
    write(folder, name, data)
    anim = _decode_all_frames(data)
    stem = name.rsplit(".", 1)[0]
    for i, frame in enumerate(anim.frames):
        alpha = anim.alphas[i] if anim.alphas is not None else None
        write(folder, f"{stem}.f{i}.png", png_bytes(frame, alpha))
    ref[stem] = {"file": name, "frames": len(anim.frames), "durations": anim.durations,
                 "loop": anim.loop, "alpha": anim.alphas is not None}


def still_fixture(folder: str, name: str, data: bytes, ref: dict, frames: int = 1) -> None:
    write(folder, name, data)
    stem = name.rsplit(".", 1)[0]
    suffix = ".p{}.png" if frames > 1 else ".png"
    for page in range(frames):
        d = pil_codec.decode(data, frame=page)
        write(folder, stem + suffix.format(page), png_bytes(d.rgb, d.alpha))
    ref[stem] = {"file": name, "pages": frames}


def gif_fixtures() -> None:
    folder, ref = os.path.join(DATA, "gif"), {"decode": {}, "encode": {}}
    rng = np.random.default_rng(18)
    frames = [Image.fromarray(photo(32, 48, 10 + k, 24 * k)) for k in range(5)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=[40, 60, 80, 100, 120], loop=0)
    animation_fixture(folder, "pil_anim.gif", buf.getvalue(), ref["decode"])
    buf = io.BytesIO()
    frames[0].save(buf, "GIF")
    animation_fixture(folder, "pil_still.gif", buf.getvalue(), ref["decode"])
    gpal = rng.integers(0, 256, size=(16, 3)).astype(np.uint8)
    lpal = rng.integers(0, 256, size=(8, 3)).astype(np.uint8)
    W, H = 40, 30

    def blk(h, w, n):
        return rng.integers(0, n, size=(h, w))

    hand = [
        dict(idx=blk(H, W, 16), disposal=1),
        dict(idx=blk(12, 17, 16), offset=(5, 7), disposal=2, transparency=5, interlace=True),
        dict(idx=blk(10, 9, 8), offset=(20, 11), local=lpal, transparency=5),
        dict(idx=blk(14, 20, 16), offset=(3, 2), disposal=3, transparency=5),
        dict(idx=blk(8, 8, 16), offset=(30, 20), code_size=5, gce=False),
        dict(idx=blk(9, 11, 16), offset=(12, 14), disposal=2),
    ]
    animation_fixture(folder, "hand_disposal.gif", fb.gif((W, H), hand, gpal, background=4),
                      ref["decode"])
    hand_t = [dict(idx=blk(H, W, 16), transparency=3, disposal=2),
              dict(idx=blk(12, 12, 16), offset=(2, 2), transparency=3, disposal=3),
              dict(idx=blk(12, 12, 16), offset=(20, 10), transparency=7)]
    animation_fixture(folder, "hand_transparent.gif", fb.gif((W, H), hand_t, gpal, loop=2),
                      ref["decode"])
    gray = [dict(idx=blk(H, W, 200), transparency=7),
            dict(idx=blk(10, 10, 200), offset=(4, 4), transparency=9, disposal=2),
            dict(idx=blk(10, 10, 200), offset=(14, 4))]
    animation_fixture(folder, "hand_gray.gif", fb.gif((W, H), gray, None), ref["decode"])

    # the encoder's bars: the JAX package's encodes of seeded frames
    src = [photo(32, 48, 30 + k, 16 * k) for k in range(4)]
    src.insert(2, src[1].copy())  # a repeated frame merges into the one before
    y, x = np.mgrid[0:32, 0:48]
    alphas = [np.where((x + 6 * k) % 32 < 20, 255, 0).astype(np.uint8) for k in range(len(src))]
    alphas[0][:] = 255
    alphas[3] = np.clip((x * 4 + y) % 256, 0, 255).astype(np.uint8)
    for i, (f, a) in enumerate(zip(src, alphas)):
        write(folder, f"enc.f{i}.png", png_bytes(f, a))
    durations = [50, 70, 90, 110, 130]
    jobs = {
        "jax_still.gif": (pil_codec.encode(src[0], "gif"), None, [100], None),
        "jax_anim.gif": (_encode_gif_animation(src, None, durations, 0), None, durations, 0),
        "jax_anim_alpha.gif": (_encode_gif_animation(src, alphas, durations, None), alphas,
                               durations, None),
    }
    for name, (blob, a, durs, loop) in jobs.items():
        write(folder, name, blob)
        anim = _decode_all_frames(blob)
        kept = [0] + [i for i in range(1, len(src)) if not (
            np.array_equal(src[i], src[i - 1])
            and (a is None or np.array_equal(a[i] >= 128, a[i - 1] >= 128)))]
        scores = []
        for k, i in enumerate(kept[: len(anim.frames)]):
            mask = None if a is None else a[i] >= 128
            scores.append(psnr(anim.frames[k], src[i], mask))
        ref["encode"][name] = {"bytes": len(blob), "frames": len(anim.frames),
                               "durations": anim.durations, "loop": anim.loop,
                               "psnr": scores, "alpha": a is not None,
                               "source_frames": kept[: len(anim.frames)]}
    ref["encode_inputs"] = {"frames": len(src), "durations": durations}
    write(folder, "reference.json", json.dumps(ref, indent=1).encode())


def webp_fixtures() -> None:
    folder, ref = os.path.join(DATA, "webp_anim"), {}
    rng = np.random.default_rng(19)
    y, x = np.mgrid[0:32, 0:48]
    frames = []
    for k in range(4):
        a = np.clip(((x + 9 * k) % 48) * 6, 0, 255).astype(np.uint8)
        a[(y // 8) % 2 == 0] = 255
        frames.append(Image.fromarray(np.dstack([photo(32, 48, 40 + k, 20 * k), a])))
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=[40, 50, 60, 70], loop=3, quality=70, minimize_size=True)
    animation_fixture(folder, "lossy_alpha.webp", buf.getvalue(), ref)
    buf = io.BytesIO()
    rgb = [Image.fromarray(photo(32, 48, 50 + k, 30 * k)) for k in range(3)]
    rgb[0].save(buf, "WEBP", save_all=True, append_images=rgb[1:], duration=90, loop=0,
                lossless=True)
    animation_fixture(folder, "lossless.webp", buf.getvalue(), ref)

    def rgba(h, w, seed):
        a = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
        a[: h // 3] = 255
        a[-2:] = 0
        return np.dstack([photo(h, w, seed), a])

    hand = [
        dict(payload=fb.webp_frame(rgba(32, 48, 60), lossless=True), size=(48, 32),
             duration=30),
        dict(payload=fb.webp_frame(rgba(14, 20, 61), lossless=False), size=(20, 14),
             offset=(10, 8), duration=40, dispose=True),
        dict(payload=fb.webp_frame(rgba(20, 22, 62), lossless=True), size=(22, 20),
             offset=(16, 12), duration=50),
        dict(payload=fb.webp_frame(photo(12, 14, 63), lossless=False), size=(14, 12),
             offset=(32, 18), duration=60, blend=False, dispose=True),
        dict(payload=fb.webp_frame(rgba(32, 48, 64), lossless=False), size=(48, 32),
             duration=70, blend=False),
        dict(payload=fb.webp_frame(rgba(12, 20, 65), lossless=True), size=(20, 12),
             offset=(2, 20), duration=80),
    ]
    animation_fixture(folder, "hand_blend.webp",
                      fb.webp_animation((48, 32), hand, alpha=True, loop=1), ref)
    write(folder, "reference.json", json.dumps(ref, indent=1).encode())


def raster_fixtures() -> None:
    folder, ref = os.path.join(DATA, "raster"), {}
    rng = np.random.default_rng(20)
    H, W = 23, 37
    pal = rng.integers(0, 256, size=(256, 3)).astype(np.uint8)
    rgba = np.dstack([photo(H, W, 70), rng.integers(0, 256, size=(H, W)).astype(np.uint8)])
    runs = np.repeat(rng.integers(0, 16, size=(H, W // 4 + 1)), 4, axis=1)[:, :W]
    runs = runs.astype(np.uint8)
    runs[3, 5:20] = rng.integers(0, 16, 15)
    words = rng.integers(0, 65536, size=(H, W)).astype(np.uint16)
    bmps = {
        "bmp_1bit.bmp": fb.bmp(rng.integers(0, 2, size=(H, W)).astype(np.uint8), bits=1,
                               palette=pal[:2]),
        "bmp_4bit.bmp": fb.bmp(rng.integers(0, 16, size=(H, W)).astype(np.uint8), bits=4,
                               palette=pal[:16]),
        "bmp_8bit_v5.bmp": fb.bmp(rng.integers(0, 256, size=(H, W)).astype(np.uint8), bits=8,
                                  palette=pal, header=124),
        "bmp_core_8bit.bmp": fb.bmp(rng.integers(0, 256, size=(H, W)).astype(np.uint8),
                                    bits=8, palette=pal, header=12),
        "bmp_rle8.bmp": fb.bmp(runs, bits=8, palette=pal, compression=1),
        "bmp_rle4.bmp": fb.bmp(runs, bits=4, palette=pal[:16], compression=2),
        "bmp_555.bmp": fb.bmp(words, bits=16),
        "bmp_565.bmp": fb.bmp(words, bits=16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_24_topdown.bmp": fb.bmp(rgba[..., :3], bits=24, top_down=True),
        "bmp_32_raw.bmp": fb.bmp(rgba, bits=32, layout="BGRA"),
        "bmp_32_bgra_v4.bmp": fb.bmp(rgba, bits=32, compression=3, header=108,
                                     masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), layout="BGRA"),
    }
    for name, data in bmps.items():
        still_fixture(folder, name, data, ref)
    idx4 = rng.integers(0, 16, size=(16, 16)).astype(np.uint8)
    mask = (rng.random((16, 16)) < 0.3).astype(np.uint8)
    d4 = fb.ico_dib(idx4, bits=4, palette=pal[:16], mask=mask)
    d32 = fb.ico_dib(rgba[:16, :16, :3], bits=32, alpha=rgba[:16, :16, 3])
    d24 = fb.ico_dib(np.ascontiguousarray(np.tile(rgba[:16, :16, :3], (2, 2, 1))), bits=24,
                     mask=np.tile(mask, (2, 2)))
    buf = io.BytesIO()
    Image.fromarray(rgba[:20, :20]).save(buf, "PNG")
    icos = {
        "ico_dib4.ico": fb.ico([d4], [(16, 16)], [4]),
        "ico_dib32.ico": fb.ico([d32], [(16, 16)], [32]),
        "ico_multi.ico": fb.ico([d4, d24, d32], [(16, 16), (32, 32), (16, 16)], [4, 24, 32]),
        "ico_png.ico": fb.ico([d4, buf.getvalue()], [(16, 16), (20, 20)], [4, 32]),
    }
    for name, data in icos.items():
        still_fixture(folder, name, data, ref)
    g16 = rng.integers(0, 1024, size=(H, W, 1)).astype(np.uint16)
    a = rgba[..., 3:]
    prem = np.concatenate([(rgba[..., :3].astype(int) * a // 255).astype(np.uint8), a], -1)
    cmap4 = [int(v) * 257 for c in range(3) for v in pal[:16, c]]
    tiffs = {
        "tiff_rgb_lzw_pred2.tif": [dict(samples=rgba[..., :3], bits=8, photometric=2,
                                        compression=5, predictor=2, rows_per_strip=5)],
        "tiff_rgba_assoc_deflate.tif": [dict(samples=prem, bits=8, photometric=2, extra=[1],
                                             compression=8)],
        "tiff_gray16_packbits_be.tif": [dict(samples=g16, bits=16, photometric=1,
                                             compression=32773)],
        "tiff_pal4.tif": [dict(samples=rng.integers(0, 16, size=(H, W, 1)).astype(np.uint8),
                               bits=4, photometric=3, colormap=cmap4)],
        "tiff_bilevel_wiz.tif": [dict(samples=(rng.random((H, W, 1)) < 0.5).astype(np.uint8),
                                      bits=1, photometric=0, compression=32773)],
        "tiff_rgb_tiled_be.tif": [dict(samples=rgba[..., :3], bits=8, photometric=2,
                                       compression=8, predictor=2, tile=(16, 16))],
        "tiff_la_lzw.tif": [dict(samples=np.concatenate([g16.astype(np.uint8), a], -1), bits=8,
                                 photometric=1, extra=[2], compression=5)],
        "tiff_orient6.tif": [dict(samples=rgba[..., :3], bits=8, photometric=2, orientation=6)],
        "tiff_rgba16.tif": [dict(samples=rng.integers(0, 65536, size=(H, W, 4)).astype(np.uint16),
                                 bits=16, photometric=2, extra=[2], compression=5,
                                 predictor=2)],
    }
    for name, pages in tiffs.items():
        still_fixture(folder, name, fb.tiff(pages, big_endian=name.endswith("_be.tif")), ref)
    pages = [dict(samples=rgba[..., :3], bits=8, photometric=2, compression=5),
             dict(samples=g16.astype(np.uint8), bits=8, photometric=1, compression=8),
             dict(samples=rgba, bits=8, photometric=2, extra=[2], compression=32773)]
    still_fixture(folder, "tiff_multipage.tif", fb.tiff(pages), ref, frames=3)
    write(folder, "reference.json", json.dumps(ref, indent=1).encode())


def main() -> None:
    gif_fixtures()
    webp_fixtures()
    raster_fixtures()


if __name__ == "__main__":
    main()
