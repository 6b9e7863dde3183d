"""The PyTorch package's lossy WebP encoder against the JAX package's.

    JAX_PLATFORMS=cpu python tools/webp_rd.py [--qualities 50,75,90]

For each image (``tests/data/jpeg/source.png``, its ``w_300,h_250,c_1``
answer ``tests/data/webp/answer.png``, the 45x67
``tests/data/webp/small.png`` and a smooth 40x30 image like the service
tests' small WebP source) and each quality, prints one JSON line: the
port's file bytes and PSNR (``flyimg_tpu_torch.codecs.encode``) beside the
JAX package's (``flyimg_tpu.codecs.encode``, libwebp), both decoded by the
JAX package's decoder, and their ratio and difference. File sizes and PSNR
only: the encoders' times are host times of this machine and are not
printed (``chip_smoke.py`` phase 10 times the port's on the card
machine).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def smooth_image() -> np.ndarray:
    """A smooth 40x30 image after a lossy WebP round trip (Pillow, q 80)."""
    from PIL import Image

    yy, xx = np.mgrid[0:30, 0:40].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(yy / 37.0 + c) * np.cos(xx / 53.0 - c)
                    for c in range(3)], -1)
    blob = np.exp(-((yy - 9) ** 2 + (xx - 28) ** 2) / (2 * 30.0 ** 2))[..., None]
    img = img * (1 - blob) + np.array([200.0, 146.0, 112.0]) * blob
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "WEBP", quality=80)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


def images() -> dict:
    from flyimg_tpu_torch.codecs import png

    def read(*parts):
        with open(os.path.join(ROOT, "tests", "data", *parts), "rb") as fh:
            return png.decode(fh.read())[0]

    return {"source": read("jpeg", "source.png"), "answer": read("webp", "answer.png"),
            "small": read("webp", "small.png"), "smooth40x30": smooth_image()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--qualities", default="50,75,90")
    args = parser.parse_args(argv)

    import flyimg_tpu.codecs as jcodecs
    from flyimg_tpu_torch import codecs

    for name, px in images().items():
        for q in (int(v) for v in args.qualities.split(",")):
            port = codecs.encode(px, "webp", quality=q)
            jax = jcodecs.encode(px, "webp", quality=q, webp_lossless=False)
            p_port = psnr(jcodecs.decode(port).rgb, px)
            p_jax = psnr(jcodecs.decode(jax).rgb, px)
            print(json.dumps({"image": name, "size": [px.shape[1], px.shape[0]], "quality": q,
                              "port_bytes": len(port), "port_psnr": round(p_port, 4),
                              "jax_bytes": len(jax), "jax_psnr": round(p_jax, 4),
                              "bytes_ratio": round(len(port) / len(jax), 4),
                              "psnr_diff_db": round(p_port - p_jax, 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
