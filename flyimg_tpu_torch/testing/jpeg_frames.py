"""Frames at the edges of the JPEG encoder's kernels (K16, K17).

``chip_smoke.py`` phase 3 holds the kernels to their plain versions on
each case, coefficient for coefficient; ``tests/test_torch_jpeg_encode.py``
holds the plain versions' encodes of the same cases to the JAX package's
native encoder on the CPU, byte for byte.

- flat 0, 128 and 255: every AC candidate absent, the program's chains
  all ties (a position with no candidate keeps w = 1e30, and 1e30 plus a
  rate rounds back to 1e30);
- 0/255 checkerboards of 1 and 8 pixels at q100: the largest AC values
  (near the 1023 clamp of the trellis's candidates) and K17's largest
  intermediates;
- q1 on the fixtures' 300x250 source: every quantizer at its largest;
- 1x1, 8x8 and 9x9 noise: a block's edge replication and partial MCUs;
- a 1920x1080 photo-like frame at q90 4:2:0: the subsampled chroma at
  size.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE_PNG = os.path.join(_ROOT, "tests", "data", "jpeg_enc", "source.png")

#: (frame, quality, luma sampling factors)
CASES: List[Tuple[str, int, Tuple[int, int]]] = [
    ("flat0", 90, (1, 1)), ("flat0", 50, (2, 2)),
    ("flat128", 90, (1, 1)), ("flat128", 50, (2, 2)),
    ("flat255", 90, (1, 1)), ("flat255", 50, (2, 2)),
    ("checker1", 100, (1, 1)), ("checker1", 100, (2, 2)),
    ("checker8", 100, (1, 1)), ("checker8", 100, (2, 1)),
    ("source", 1, (1, 1)), ("source", 1, (2, 2)),
    ("noise1x1", 90, (1, 1)), ("noise1x1", 90, (4, 2)),
    ("noise8x8", 90, (2, 2)),
    ("noise9x9", 100, (2, 2)), ("noise9x9", 75, (1, 3)),
    ("photo1920x1080", 90, (2, 2)),
]


def _checker(w: int, h: int, cell: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    board = (((yy // cell) + (xx // cell)) % 2 * 255).astype(np.uint8)
    return np.repeat(board[..., None], 3, 2)


def _noise(w: int, h: int) -> np.ndarray:
    return np.random.default_rng(w * 100 + h).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _photo(w: int, h: int) -> np.ndarray:
    """Smooth colour waves, soft blobs, a sharp rectangle and mild noise."""
    rng = np.random.default_rng(1920)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([110 + 60 * np.sin(yy / (37.0 + 11 * c) + xx / (53.0 - 7 * c) + c)
                    for c in range(3)], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w, rng.uniform(20, 150)
        mask = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        img = img * (1 - mask) + rng.uniform(0, 255, 3) * mask
    img[h // 5:h // 5 + h // 6, w // 3:w // 3 + w // 6] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def frame(name: str) -> np.ndarray:
    """The named frame, [h, w, 3] u8 (read only)."""
    if name.startswith("flat"):
        img = np.full((24, 40, 3), int(name[4:]), np.uint8)
    elif name == "checker1":
        img = _checker(32, 24, 1)
    elif name == "checker8":
        img = _checker(48, 32, 8)
    elif name == "source":
        from flyimg_tpu_torch.codecs import png

        with open(SOURCE_PNG, "rb") as fh:
            img, _ = png.decode(fh.read())
    elif name.startswith("noise"):
        w, h = (int(v) for v in name[5:].split("x"))
        img = _noise(w, h)
    elif name == "photo1920x1080":
        img = _photo(1920, 1080)
    else:
        raise KeyError(name)
    img = np.ascontiguousarray(img)
    img.setflags(write=False)
    return img
