"""The PyTorch package stands alone: importing every module of
flyimg_tpu_torch (and chip_smoke.py) loads neither jax nor the JAX package;
its entry points default to CUDA and raise on a host without it instead of
running on the CPU; chip_smoke.py fails, printing no result, without a card
and without the package beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flyimg_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            flyimg_tpu_torch.__path__, prefix="flyimg_tpu_torch."
        )
    )


def test_every_module_imports_without_jax_or_the_jax_package(tmp_path):
    """Every module imports, the face backends load the packaged BlazeFace
    weights (the .npz) and run, and the codecs decode an oriented PNG, build
    and run the WebP codec (lossless, lossy, lossy with alpha), encode and
    decode a still GIF and a two-frame animated one, decode a BMP and
    refuse a JPEG on the CPU by name, with neither JAX, the JAX package nor
    Pillow (which the card machine lacks) loaded."""
    mods = _all_modules()
    assert "flyimg_tpu_torch.service.app" in mods
    assert "flyimg_tpu_torch.models.blazeface" in mods
    assert "flyimg_tpu_torch.models.haar" in mods
    for name in ("exif", "metadata", "native_codec"):
        assert f"flyimg_tpu_torch.codecs.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from flyimg_tpu_torch.entry import skin_ellipse_image\n"
        "from flyimg_tpu_torch.models.faces import make_face_backend\n"
        "img = skin_ellipse_image(np.random.default_rng(0), 300, 400)\n"
        "for name in ('blazeface', 'facefind'):\n"
        "    ff = make_face_backend(name, device='cpu')\n"
        "    boxes = ff.detect_faces_batched([ff.prepare_face_work(img)])[0]\n"
        "    assert boxes, name\n"
        "    ff.blur_faces(img, boxes)\n"
        "from flyimg_tpu_torch import codecs\n"
        "small = img[:20, :30]\n"
        "back = codecs.decode(codecs.encode(small, 'webp', webp_lossless=True))\n"
        "assert (back.rgb == small).all()\n"
        "lossy = codecs.encode(small, 'webp', quality=75)\n"
        "assert lossy[12:16] == b'VP8 ' and codecs.decode(lossy).size == (30, 20)\n"
        "alpha = np.tile(np.arange(30, dtype=np.uint8) * 8, (20, 1))\n"
        "back = codecs.decode(codecs.encode(small, 'webp', alpha, quality=75))\n"
        "assert (back.alpha == alpha).all()\n"
        "assert codecs.decode(codecs.encode(small, 'png')).size == (30, 20)\n"
        "still = codecs.decode(codecs.encode(small, 'gif'))\n"
        "assert still.mime == 'image/gif' and still.size == (30, 20)\n"
        "jpg = codecs.encode(small, 'jpg', device='cpu')\n"
        "assert jpg[:4] == b'\\xff\\xd8\\xff\\xe0' and jpg[-2:] == b'\\xff\\xd9'\n"
        "from flyimg_tpu_torch.codecs import jpeg_enc\n"
        "assert jpeg_enc.encode_cmyk(small, 90, device='cpu')[2:4] == b'\\xff\\xee'\n"
        "anim = codecs.encode_animation([small, 255 - small], None, [50, 70], 0)\n"
        "assert codecs.decode(anim).n_frames == 2\n"
        "frames = codecs.decode_all(anim)\n"
        "assert frames.durations == [50, 70] and frames.loop == 0\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import format_writers\n"
        "bmp = format_writers.bmp(small, bits=24)\n"
        "assert (codecs.decode(bmp).rgb == small).all()\n"
        "assert codecs.decode(jpg, device='cpu').size == (30, 20)\n"
        "from flyimg_tpu_torch.exceptions import ExecFailedException\n"
        "try:\n"
        "    codecs.decode(b'\\xff\\xd8\\xff\\xe0' + bytes(60), device='cpu')\n"
        "    raise SystemExit('a broken JPEG decoded')\n"
        "except ExecFailedException as exc:\n"
        "    assert 'JPEG decode failed' in str(exc)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'flyimg_tpu' or n.startswith('flyimg_tpu.')\n"
        "             or n == 'PIL' or n.startswith('PIL.'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_the_webp_codec_builds_from_its_own_sources():
    """The port's host libraries (the WebP codec, the raster loops, the
    JPEG writer and reader) compile from the package's sources alone: no libwebp or
    libjpeg header, library or dlopen in them or in their build flags."""
    from flyimg_tpu_torch import cuda_build

    pkg = os.path.join(ROOT, "flyimg_tpu_torch")
    assert "codecs/native/jpeg_writer.cpp" in cuda_build.HOST_SOURCES["jpeg"][0]
    for name, (files, flags) in cuda_build.HOST_SOURCES.items():
        assert not any("webp" in f or "jpeg" in f for f in flags + cuda_build.HOST_FLAGS), name
        for f in files:
            with open(os.path.join(pkg, f)) as fh:
                text = fh.read()
            for bad in ("<webp/", "dlopen", "-lwebp", "libwebp.so", "jpeglib", "-ljpeg",
                        "libjpeg.so", "turbojpeg", "jerror.h"):
                assert bad not in text, (f, bad)
            for line in text.splitlines():
                if line.startswith("#include"):
                    assert line.split()[1] in ('"vp8_tables.h"', '"webp_lossless.h"') or \
                        line.split()[1].startswith("<c") or line.split()[1] in (
                            "<algorithm>", "<vector>", "<queue>", "<atomic>",
                            "<thread>"), (f, line)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the CPU-only behaviour "
                    "is what is pinned here")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _no_cuda()
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.entry import entry, face_entry
    from flyimg_tpu_torch.models import blazeface, facefind, smartcrop
    from flyimg_tpu_torch.models.faces import make_face_backend
    from flyimg_tpu_torch.ops.compose import run_plan
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.service.app import make_server
    from flyimg_tpu_torch.service.handler import ImageHandler
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    img = np.zeros((64, 64, 3), np.uint8)
    plan = build_plan(OptionsBag("w_32"), 64, 64)
    params = AppParameters({"upload_dir": str(tmp_path / "u"),
                            "tmp_dir": str(tmp_path / "t")})
    calls = [
        lambda: entry(batch=1),
        lambda: run_plan(img, plan),
        lambda: smartcrop.find_best_crops_batched([smartcrop.prepare_work(img)]),
        lambda: smartcrop.smart_crop_image(img),
        lambda: face_entry(views=1, images=1),
        lambda: blazeface.load_weights(),
        lambda: facefind.detect_faces(img),
        lambda: facefind.blur_faces(img, [(0, 0, 4, 4)]),
        lambda: make_face_backend("facefind"),
        lambda: BatchController(),
        lambda: ImageHandler(params),
        lambda: make_server(params),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    _no_cuda()
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
