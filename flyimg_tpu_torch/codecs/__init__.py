"""Host codec layer: media sniffing, PNG decode/encode.

The port's counterpart of ``flyimg_tpu/codecs``. PNG is the one container
of this package so far (codecs/png.py, on zlib and numpy); JPEG, WebP and
GIF raise ``UnsupportedMediaException`` until a later slice ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.codecs.sniff import PNG_MIME, MediaInfo, sniff
from flyimg_tpu_torch.exceptions import UnsupportedMediaException


@dataclass
class DecodedImage:
    """Host-side decoded image: RAW rgb plus a separate alpha plane."""

    rgb: np.ndarray                      # [h, w, 3] uint8
    alpha: Optional[np.ndarray]          # [h, w] uint8 or None
    mime: str

    @property
    def size(self) -> Tuple[int, int]:
        return (self.rgb.shape[1], self.rgb.shape[0])


def media_info(data: bytes) -> MediaInfo:
    """Media type + dims from the leading bytes."""
    return sniff(data[:65536])


def decode(data: bytes, info: Optional[MediaInfo] = None) -> DecodedImage:
    info = info or media_info(data)
    if info.mime != PNG_MIME:
        raise UnsupportedMediaException(
            f"decoding {info.mime} is not ported to the PyTorch package "
            "yet (PNG only)"
        )
    rgb, alpha = png.decode(data)
    return DecodedImage(rgb=rgb, alpha=alpha, mime=info.mime)


def encode(image: np.ndarray, fmt: str, alpha: Optional[np.ndarray] = None) -> bytes:
    if fmt != "png":
        raise UnsupportedMediaException(
            f"encoding {fmt} is not ported to the PyTorch package yet "
            "(png only)"
        )
    return png.encode(image, alpha)
