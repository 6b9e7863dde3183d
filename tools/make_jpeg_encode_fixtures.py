"""Write the JPEG encode fixtures the PyTorch package's encoder is held to.

    JAX_PLATFORMS=cpu python tools/make_jpeg_encode_fixtures.py [--out tests/data/jpeg_enc]

The JAX package encodes JPEG with its native library
(``flyimg_tpu/codecs/native/fastcodec.cpp``: ``fc_jpeg_encode_trellis``
for ``moz_1``, ``fc_jpeg_encode`` for ``moz_0``) and a CMYK answer with
Pillow (``flyimg_tpu.service.handler._encode_cmyk_jpeg``). The card
machine has no libjpeg, so this script, on a host with libjpeg's
development files and g++, compiles the unmodified ``fastcodec.cpp`` into
a temporary directory (never beside its source: the library there stays
as it is) and writes what ``chip_smoke.py`` compares the port's bytes
with:

- ``source.png``: a seeded 300x250 photo-like image (the flagship
  answer's size);
- ``trellis_q<q>_<h>x<v>.jpg``: ``fc_jpeg_encode_trellis`` (progressive)
  of it at q 1, 50, 90 and 100 and each of the 12 luma sampling factors
  libjpeg takes (h, v in 1..4, h * v <= 8);
- ``plain_q90_<h>x<v>.jpg``: ``fc_jpeg_encode`` (baseline, standard
  tables: ``moz_0``) at 1x3 and 2x4, two factors nvJPEG cannot write;
- ``cmyk_q90_opt<k>.jpg``: ``_encode_cmyk_jpeg`` at q90 with optimized
  Huffman tables off and on;
- ``reference.json``: each file's bytes, sha256 and parameters, and
  ``served``: three URLs whose answer from the JAX package's handler (with
  the temporary native library in place of its own) is one of these
  files byte for byte: the source is already 300x250, so
  ``w_300,h_250,c_1`` leaves its pixels as they are (``o_jpg`` because a
  PNG source answers PNG otherwise).

``tests/test_torch_jpeg_encode.py`` rebuilds all of it and fails if a
file differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "jpeg_enc")
SOURCE = os.path.join(ROOT, "flyimg_tpu", "codecs", "native", "fastcodec.cpp")

#: the luma sampling factors fc_samp_valid accepts
FACTORS = tuple((h, v) for h in range(1, 5) for v in range(1, 5) if h * v <= 8)
QUALITIES = (1, 50, 90, 100)
PLAIN_FACTORS = ((1, 3), (2, 4))
#: URL options -> the file the JAX handler answers them with (source.png)
SERVED = {"w_300,h_250,c_1,o_jpg": "trellis_q90_1x1.jpg",
          "w_300,h_250,c_1,o_jpg,moz_0,sf_2x4": "plain_q90_2x4.jpg",
          "w_300,h_250,c_1,clsp_CMYK,o_jpg": "cmyk_q90_opt1.jpg"}


def missing() -> Optional[str]:
    """Why the JAX package's native library cannot be built here, or None."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    probe = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=120)
    if probe.returncode != 0:
        return "jpeglib.h is not installed (libjpeg's development files)"
    return None


def build_fastcodec(directory: str) -> str:
    """Compile the unmodified fastcodec.cpp into ``directory``; returns the
    library's path."""
    out = os.path.join(directory, "libfastcodec.so")
    errors = []
    # hosts with the libwebp runtime but no -dev package have no libwebp.so
    # linker name (the JAX package's Makefile tries the same)
    for webp in ("-lwebp", "-l:libwebp.so.7", "-l:libwebp.so.6"):
        proc = subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", out,
                               SOURCE, "-ljpeg", "-lpng16", webp, "-lpthread"],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode == 0:
            return out
        errors.append(proc.stderr)
    raise RuntimeError("fastcodec.cpp did not build:\n" + "\n".join(errors))


class FastCodec:
    """ctypes calls of the JAX package's two JPEG encoders."""

    def __init__(self, path: str):
        self.path = path
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        size = ctypes.POINTER(ctypes.c_size_t)
        lib.fc_jpeg_encode_trellis.restype = p
        lib.fc_jpeg_encode_trellis.argtypes = [ctypes.c_char_p, i, i, i, i, i, i, size]
        lib.fc_jpeg_encode.restype = p
        lib.fc_jpeg_encode.argtypes = [ctypes.c_char_p, i, i, i, i, i, i, i, size]
        lib.fc_free.argtypes = [p]
        lib.fc_free.restype = None
        self.lib = lib

    def _take(self, ptr, n) -> bytes:
        if not ptr:
            raise RuntimeError("the native encode failed")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self.lib.fc_free(ptr)

    def trellis(self, rgb: np.ndarray, quality: int, sampling: Tuple[int, int],
                progressive: bool = True) -> bytes:
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        n = ctypes.c_size_t()
        h, w = rgb.shape[:2]
        return self._take(self.lib.fc_jpeg_encode_trellis(
            rgb.tobytes(), w, h, quality, sampling[0], sampling[1], int(progressive),
            ctypes.byref(n)), n)

    def encode(self, rgb: np.ndarray, quality: int, sampling: Tuple[int, int],
               optimize: bool = False, progressive: bool = False) -> bytes:
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        n = ctypes.c_size_t()
        h, w = rgb.shape[:2]
        return self._take(self.lib.fc_jpeg_encode(
            rgb.tobytes(), w, h, quality, int(optimize), int(progressive), sampling[0],
            sampling[1], ctypes.byref(n)), n)


def jax_native(monkeypatch, path: str) -> None:
    """Point the JAX package's ``native_codec`` at the library ``path``
    for one test (``monkeypatch`` restores every global it sets)."""
    from flyimg_tpu.codecs import native_codec

    monkeypatch.setattr(native_codec, "_LIB_PATH", path)
    for name, value in (("_lib", None), ("_POOL", None), ("_roi_symbol", False),
                        ("_roi_supported", False)):
        monkeypatch.setattr(native_codec, name, value)


def source_image() -> np.ndarray:
    rng = np.random.default_rng(1919)
    yy, xx = np.mgrid[0:250, 0:300].astype(np.float32)
    img = np.stack([120 + 85 * np.sin(yy / (17.0 + 5 * c) + c) * np.cos(xx / 29.0 - c)
                    for c in range(3)], -1)
    img[40:120, 170:250] = (206.0, 150.0, 108.0)     # a sharp-edged block
    img[::12] *= 0.7                                  # fine stripes
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def _served(files: Dict[str, bytes], lib_path: str, workdir: str) -> None:
    """Check that the JAX handler answers each SERVED URL with its file."""
    import pytest

    from flyimg_tpu.appconfig import AppParameters
    from flyimg_tpu.service.handler import ImageHandler
    from flyimg_tpu.storage import make_storage

    src = os.path.join(workdir, "source.png")
    with open(src, "wb") as fh:
        fh.write(files["source.png"])
    with pytest.MonkeyPatch.context() as mp:
        jax_native(mp, lib_path)
        params = AppParameters({"upload_dir": os.path.join(workdir, "u"),
                                "tmp_dir": os.path.join(workdir, "t")})
        handler = ImageHandler(make_storage(params), params)
        for opts, name in SERVED.items():
            got = handler.process_image(opts, src).content
            if got != files[name]:
                raise RuntimeError(f"the JAX handler's answer to {opts} is not {name}")


def build() -> Dict[str, bytes]:
    """name -> bytes of every fixture file."""
    from PIL import Image

    from flyimg_tpu.service.handler import _encode_cmyk_jpeg

    reason = missing()
    if reason:
        raise RuntimeError(reason)
    src = source_image()
    buf = io.BytesIO()
    Image.fromarray(src).save(buf, "PNG")
    files = {"source.png": buf.getvalue()}
    meta = {}
    with tempfile.TemporaryDirectory() as tmp:
        codec = FastCodec(build_fastcodec(tmp))
        for q in QUALITIES:
            for h, v in FACTORS:
                name = f"trellis_q{q}_{h}x{v}.jpg"
                files[name] = codec.trellis(src, q, (h, v))
                meta[name] = {"encoder": "fc_jpeg_encode_trellis", "quality": q,
                              "sampling": [h, v], "progressive": True}
        for h, v in PLAIN_FACTORS:
            name = f"plain_q90_{h}x{v}.jpg"
            files[name] = codec.encode(src, 90, (h, v))
            meta[name] = {"encoder": "fc_jpeg_encode", "quality": 90, "sampling": [h, v],
                          "optimize": False, "progressive": False}
        spec = type("Spec", (), {"extension": "jpg"})()
        for opt in (0, 1):
            name = f"cmyk_q90_opt{opt}.jpg"
            files[name] = _encode_cmyk_jpeg(src, spec, 90, bool(opt))
            meta[name] = {"encoder": "_encode_cmyk_jpeg", "quality": 90,
                          "optimize": bool(opt)}
        _served(files, codec.path, tmp)
    for name, entry in meta.items():
        entry["bytes"] = len(files[name])
        entry["sha256"] = hashlib.sha256(files[name]).hexdigest()
    ref = {"files": meta, "served": SERVED,
           "source": {"file": "source.png", "width": 300, "height": 250}}
    files["reference.json"] = (json.dumps(ref, indent=1, sort_keys=True) + "\n").encode()
    return files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, data in build().items():
        with open(os.path.join(args.out, name), "wb") as fh:
            fh.write(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
